"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure:

1. Card: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as nvidia-smi reports them.
2. Build: builds the CUDA kernels from ``path_tracing_tpu_torch/csrc`` and
   prints the build seconds and each kernel's ptxas registers and spills
   (``*_counts``: the counting builds); then the occupancy (resident blocks
   and warps per SM at the launch shape, registers, local and shared
   bytes) of each BDPT kernel, for #9 on cornell against the main path's
   K = 32 tables and the exact table, for #8 against the exact table (its
   path's), and of #1, #2, #3, #5, #10 and #11 and their counting
   builds, and of ``ppm_eye``.
3. Kernels against their plain PyTorch versions at the main path's lane
   count (1920x1080 = 2,073,600), with their times (CUDA events):
   ``threefry_rows`` bit for bit; ``nearest_hit``, ``any_blocker`` (both
   without a mask: every lane walked) and
   ``shade_step`` on ``scenes/cornell.txt``; #3's counting build
   (``shade_step_counts``) over every bounce of a 128x72 spp 4 fused frame
   on cornell (outputs bit-equal to #3's, counters summed over the bounces
   equal to the plain version's exactly), then #3 on the lanes of the
   1080p fused frame's first bounce, recorded from the render: against its
   plain version, its counting build bit-equal and within 0.1% of the
   plain counts, with the SIMT of its walk, shade and shadow step and its
   bound counted from the plain counts beside its floor, and #3 timed on
   each of the frame's recorded bounces;
   ``nearest_hit(with_uv)`` and
   ``shade_step_tex`` on a 1,280-triangle textured icosphere (checked
   only: #4 is timed at its main path's shape in phase 5); the
   ``render_wavefront`` megakernel's 1080p spp 4 image on cornell.  Then
   #5's counting build (``render_wavefront_counts``): its image bit-equal
   to #5's and its counters equal to the plain loop's count of the same
   work (paths, iterations, NEE shadow rays with their evaluations and
   pdfs, BSDF samples, draws, and the walks' sphere, box and triangle
   tests in the kernel's walk order) exactly at 128x72 spp 4 on cornell
   and on the untextured 17,000-triangle icosphere (512 clusters: the
   super walk), and within
   0.1% at 1080p, with the SIMT efficiency of the walk, the shade and the
   shadow step, the share of each warp's lane-iterations that are busy
   (against one thread a pixel, from the plain counts) and #5's bound
   from the plain counts.  Then #1 at the shapes its main paths launch it
   on, recorded from the integrators' own calls: every launch of the PPM
   eye loop as it ran before ``ppm_eye`` (``ppm_eye_plain`` on #1; 262,144
   lanes, its alive lanes live), each bit-equal to its plain version on
   every lane and timed device-only, with ``ppm_eye``'s outputs bit-equal
   to the loop's on every pixel, and the first launch of the BDPT light
   loop as it ran before ``bdpt_light`` (``light_trace_plain`` on #1).
   Then ``bdpt_light`` on the main path's light trace (cornell, spl 8:
   256 paths, light depth 4, seed 0), its 13 fields bit-equal to that
   loop's on every vertex, timed device-only (graph replay) and with the
   host's enqueue beside the loop with its host, its bound from the
   loop's count of its work (walks' tests, BSDF samples, reverse pdfs,
   draws: ``cuda_bdpt_light.new_counts``), and the light side of the
   frame (``light_side``) with its host through either.
4. PT paths on cornell through the CLI at 1920x1080, spp 4, eye depth 4:
   the default tier (auto, which is the megakernel: the main path), the
   fused tier (one ``shade_step`` per bounce) and the split tier (the
   nearest-hit and any-blocker kernels around a PyTorch bounce).  Launches
   are counted over each render on its own; no plain version may run.  The
   mega image must equal the fused image pixel for pixel (bar: 99.9%).
   Then 128x72 spp 4 in the kernel tiers and the plain tier from the same
   key, compared pixel by pixel.  #1's and #2's launches in the two split
   frames are recorded where the wrappers launch, with their masks
   (``kernel_times.record_launches``): each of the 1080p frame's 47 + 47
   bit-equal to its plain version on every lane (the lanes that are not
   live with the miss record or false) and timed device-only (CUDA-graph
   replay); the counting builds (``nearest_hit_counts``,
   ``any_blocker_counts``) bit-equal to the kernels, their counters (the
   walks' sphere, box and triangle tests) summed over the 128x72 frame's
   launches equal to the plain versions' exactly and within 0.1% on the
   1080p frame's first launch, whose time and bound (the live lanes'
   rays, the mask and every lane's record; the walks' counted tests)
   are #1's and #2's, beside the floor (each live lane's spheres and every
   box).
5. Textured PT: an 81,920-triangle textured icosphere (2,048 clusters,
   128 supers) written as OBJ + MTL + PNG, rendered through the CLI at
   1920x1080 spp 4 (auto: the fused tier with ``shade_step_tex``), the
   lanes of its first bounce recorded from the render: #4 on them against
   its plain version on a strided subset of >= 65,536 lanes (every output
   within rtol 1e-4 / atol 1e-5 on >= 99.9%), its counting build
   (``shade_step_tex_counts``: outputs bit-equal to #4's, its counters
   (active lanes, NEE shadow rays with their evaluations and pdfs, BSDF
   samples, the walks' tests) equal to the plain version's exactly on the
   subset and within 0.1% on every lane), with the SIMT of the walk, the
   shade and the shadow step and #4's bound counted from the plain counts
   beside its floor; then 128x72 spp 4 on the 1,280-triangle
   icosphere in the kernel tiers against the plain tier.
6. BDPT kernels.  At 128x72 spp 4 on cornell, tile-RIS K = 32 and the
   exact sweep: #9's counting build (``bdpt_eye_counts``) bit-equal to #9,
   #9 against its plain version, and the counting build's counters
   against the plain version's count of the same work (vertices, rows,
   rows past the geometry and cone gates, evaluations, pdfs, shadow rays,
   contributions, and the nearest-hit and shadow walks' sphere, box and
   triangle tests in the kernels' cluster order: within 0.1%), with the
   SIMT efficiency of the row and shadow steps; #9 on a second scene, the
   untextured 1,280-triangle icosphere at 128x72 (these three at the
   strict bar alone); #8's counting build on the 128x72 frame's primary
   hits with a third of the lanes active, its sums #8's and its counters
   the plain version's exactly.  Then on the tables of the CLI's first
   1920x1080 BDPT frame (spl 8, seed 0), built by the integrator's
   ``light_side`` and ``light_table``: ``connect`` on the primary hits
   against the exact sweep's shared table (max-channel relative error
   < 1e-3 on every active lane, every inactive lane 0); ``bdpt_eye`` with
   the shared table at spp
   1 on the frame's middle quarter of lanes (rows 405-674: the window
   draws the whole frame's Threefry counters) and with the main path's
   127 tile-local RIS K = 32 tables at spp 4 on every lane
   (mean within 1e-3 and >= 99% of pixels within rtol 1e-4 / atol 1e-5,
   else the JAX package's BDPT tier bar: >= 97% within 1e-3, mean within
   5%; the bar that held is printed); each with its counting build's
   counters against the plain run's, and its bound from the plain run's
   counts.
7. BDPT through the CLI on cornell at 1920x1080, spp 4, spl 8, eye and
   light depth 4: tile-local RIS K = 32 (auto: the mega tier, the main
   path), whose image must equal phase 6's ``bdpt_eye`` image on >= 99.9%
   of pixels; the exact sweep in the mega tier and in the fused tier from
   the same key.  Mega launches ``bdpt_eye`` once a frame and no
   ``connect``, fused launches ``connect`` per bounce; both trace the light
   paths with one ``bdpt_light`` launch after the emission's
   ``threefry_rows``; no plain version may run; #8 is timed (CUDA events)
   on each of the fused frame's launches, beside its active lanes, and
   #1's 48 launches there (the eye pass's) are recorded, each held bit for bit
   against its plain version on every lane and timed device-only.  The
   exact mega image must equal the fused one on >= 99.9% of pixels.  Then
   the BDPT ground truth through the CLI, ``--device oracle`` on cornell
   at 256x256 spp 16 (spl 8, BASELINE config 1's shape), whose auto tier
   is the fused one: rendered twice, the two images bit-equal, with its
   wall time and #8's launches (no ``bdpt_eye``, no plain version).
8. PPM kernels against their plain versions on cornell at the main path's
   shape, the CLI's first 512x512 PPM pass (4 lights x 262,144 = 1,048,576
   photons, eye and light depth 4, seed 0), built by the integrator's own
   functions: ``ppm_eye`` (the pass's eye pass) bit-equal to the eye loop
   on #1 and ``threefry_rows`` (``ppm_eye_plain``, the pass before the
   kernel) on every pixel, timed device-only (graph replay) and with the
   host's enqueue, its bound from the loop's counts of its work on the
   plain nearest hit (walk tests, chain links, delta samples, draws);
   ``photon_trace`` on the pass's emission (valid flags equal and
   every field within rtol 1e-5 / atol 1e-6 on >= 99.99% of rows; the share
   of bit-equal rows is printed), its counting build
   (``photon_trace_counts``: events bit-equal to #10's, its counters
   (photons, bounces, the walk's sphere, box and triangle tests, BSDF
   samples, draws, deposits) equal to the plain loop's count exactly on a
   pass of 4 x 4,096 photons and within 0.1% on the main pass, with the
   bounce step's SIMT, the share of each warp's bounce slots that are busy
   (against one thread a photon, from the plain counts) and #10's bound
   from the plain counts; #10 timed through its wrapper, which makes no
   device round trip) and ``gather_flux`` on the pass's real
   hitpoints and #10's events (counts equal on >= 99.99% of hitpoints, flux
   within rtol 1e-4 / atol 1e-6 on >= 99.9%, means within 1e-5 relative),
   with the candidate pairs, occupied cells and overflow.  Then #11's
   counting build (``gather_flux_counts``): flux and counts bit-equal to
   #11's, its counters (candidate pairs, pairs past the distance gate and
   both gates, evaluations, accepted pairs) equal to the plain join's
   count exactly on a 128x128 eye pass against the same photons and within
   0.1% on the main path's pass, with the SIMT efficiency of the pair test
   and the evaluation, the largest warp's candidate pairs against the
   mean warp's, the work items and the event bytes staged in shared
   memory.
9. PPM through the CLI on cornell at 512x512, 262,144 photons a light, 10
   passes (the main path): one pass first, whose image must equal phase 8's
   on >= 99.9% of pixels, then the 10 passes with their launches counted:
   ``ppm_eye``, ``photon_trace`` and ``gather_flux`` once a pass, no
   ``nearest_hit`` and no plain version.
10. The mesh kernels on a 327,680-triangle textured icosphere, written as
   OBJ + MTL + PNG (the write and the parse timed): on the lanes of the
   stream tier's first two iterations of the CLI's 1080p frame (2,073,600
   each), recorded from a stream-tier render and sorted by the path's own
   ``sorted_call``, ``nearest_hit_stream`` (#6, resolved with ``with_uv``)
   against ``nearest_hit`` (#1) on every lane (flags equal on >= 99.99%,
   t bit-equal on >= 99.95%, the fields equal wherever the winning
   triangle is the same, iu/iv within 1e-5 on >= 99.9% of triangle hits)
   and against its plain version on a strided subset of >= 65,536 lanes
   (kind, t and index, the same bars); on the first iteration, #6's
   counting build (``nearest_hit_stream_counts``: (t, idx, kind) bit-equal
   to #6's, its counters (rays, sphere tests, super, cluster and block
   boxes, triangles) equal to the plain model of its walk exactly on the
   subset's live lanes and within 0.1% on every live lane, with the
   triangle test's SIMT and #6's bound from the model's counts, beside a
   floor that leaves out the super boxes);
   #1's time on the same sorted live lanes (the resident super walk)
   beside #6's; ``any_blocker_stream`` (#7) on the
   path's NEE shadow rays, on the NEE-eligible lanes only, against
   ``any_blocker`` (#2) on all of them and its plain version on a strided
   subset; on the first iteration its counting build
   (``any_blocker_stream_counts``: verdicts equal to #7's, its counters
   (rays, sphere tests, super, cluster and block boxes, triangles, up to
   the first blocker) equal to the plain model of its walk exactly on the
   subset and within 0.1% on every live lane, and #7's bound from the
   model's counts beside its floor), then on 2,073,600 random
   shadow segments through the mesh,
   under both blocking rules: verdicts equal on >= 99.99%, at most 1% of
   the reference's blocked lanes differ, and 5-95% of the lanes are
   blocked; both timed on the same live lanes sorted and in lane order,
   then on each iteration's sorted lanes of the frame (the per-bounce
   times, beside each live count).
   Then ``onehot_fetch`` (#12) at rows
   128 x D 4,352 / 16,640 / 66,048 through its entry point (the probe's
   path), bit-equal to its plain version and to ``tab[:, idx]``, timed
   beside both: device-only (100 calls captured in a CUDA graph and
   replayed: ``ms`` and ``library_ms``) and a call with the host's enqueue
   (20 calls back to back: ``host_ms`` and ``library_host_ms``).
11. PT's ``auto`` above the resident ceiling: on the convex icosphere
   and on the enclosed scene (``scenes/cornell.txt``'s room, blocks,
   spheres and lights with the icosphere at radius 0.35 on the floor:
   327,716 triangles), untextured and textured, in process at 1920x1080
   spp 4 from one key, the stream tier against the resident one (mega
   untextured, fused textured: #5 / #4 on the super walk) in turns
   (stream, resident, resident, stream), the times printed; auto must not
   pick a tier that was slower in every turn (each tier warmed up at
   128x72 first), and #5's counting build at 128x72 prints the walks'
   tests a bounce and a shadow ray on the untextured scenes; images >= 99.9% of
   pixels equal on the untextured convex mesh, >= 99% textured and on the
   enclosed scene (whose mirror, glass and diamond chains carry #6's
   last-ulp differences from #1 into whole paths); every image more than
   1% non-zero.  Then through the CLI: auto on the
   textured OBJ (``shade_step_tex`` and ``threefry_rows``, no #5, #6),
   ``--tier stream`` on it (#6, #7 and ``threefry_rows``, no #1, #4, #5;
   the path #6's and #7's launches are counted on) and auto on the
   untextured enclosed scene written as a text scene (#5 alone; its image
   equal to the in-process mega image on >= 99.9%).
12. PPM on the enclosed scene: the eye loop's #1 launches of the first
   512x512 pass (``ppm_eye_plain`` on #1), each against its plain
   version bit for bit on a strided subset of at most 16,384 of its live
   lanes (the plain version is a brute force over 327,716 triangles) and
   timed device-only; #10 (its super-walk instance) against its plain
   version on the pass's first 4,096 photons (valid flags equal and
   fields within rtol 1e-5 / atol 1e-6 on >= 99.99% of rows) and timed on
   the whole pass; then through the CLI's auto at 512x512, 3 passes of 4 x
   262,144 photons (``ppm_eye``, #10 and #11, no plain version),
   with ms a pass and Mphotons/s.
13. BDPT on the enclosed scene: #9 against its plain version at 32x18
   spp 1 on its tile-RIS K = 32 tables (phase 6's bars), ``bdpt_light``'s
   super-walk instance on the 1080p frame's light trace held and timed as
   in phase 3 (``bdpt_light_super``), then through the CLI's auto (mega:
   #9 once, no #8) at 1920x1080 spp 4, spl 8, tile-RIS K = 32.
14. Checkpoints through the CLI on cornell at 1920x1080 spp 4: two
   iterations with ``--checkpoint``, then a resume for one more,
   bit-equal to three uninterrupted iterations; and a 128x72 render with
   ``--profile``, whose Chrome trace must hold events (its kernel events
   are printed).
15. Legacy-Ks cornell (``legacy_cornell``: ``scenes/cornell.txt`` with a
   K record on its glass sphere's material) through the CLI at 1920x1080
   spp 4: PT (auto: the split tier, ``transmittance_rgb`` in place of
   #2), every launch of the frame recorded where ``cuda_shade`` calls it
   and held against ``transmittance_rgb_plain`` (rtol 1e-6 / atol 1e-7 on
   every live lane, exactly 1 on the others), each timed, the first's
   bound from the plain walk model's counts; BDPT (spl 8, global RIS
   K = 32; auto: fused, #8's RGB instance ``connect_rgb``), every launch
   recorded at ``cuda_connect._launch`` and held against ``connect_plain``
   (phase 6's bar: max-channel relative error < 1e-3 on every active
   lane, every inactive lane 0), each timed, the first's bound from the
   plain counts; PPM at 512x512 for 3 passes, bit-equal to cornell's
   without the record.
16. Sampled connections: cornell through the CLI at 1080p spp 4, spl 8,
   the exact table, ``--conn-samples 16`` (auto: fused, #8's sampled
   instance ``connect_sampled``), every launch held and timed as in 15.
17. BDPT and PPM on phase 5's textured OBJ through the CLI: BDPT at 1080p
   spp 4, spl 8, K = 32 (auto: fused, the ``with_uv`` #1 and #8), and
   ``bdpt_light_tex`` (its super walk) on that frame's light trace held
   and timed as in phase 3, and held on the 1,280-triangle textured
   icosphere in cornell's room (its walls send light paths onto the
   texture); #10's
   textured instance ``photon_trace_tex`` against its plain version on the
   first 4,096 photons of the first 512x512 pass (phase 12's bar), timed
   there and on the whole pass (``pass_ms``), and on 4,096 photons of
   cornell's lights with the 1,280-triangle textured icosphere in its room
   (the same bar; photons bounce off the sphere onto the walls, so later
   deposits carry the texel in their flux); its bound over the whole
   pass (``pass_bound_ms``) from the pass's bytes and the walks of #10's
   untextured counting build on the same photons (a texel scales a
   photon's flux, not its path: their events' flags and positions are
   held equal); then PPM at 512x512, 10 passes of 1,048,576 photons (#1,
   ``photon_trace_tex``, #11).
18. The hash-grid gather (``integrators/ppm.py::gather_flux_hash``,
   PyTorch) on the first 512x512 pass's hitpoints and #10's events: at the
   defaults (K = 64: kmax, overflow, time), then at K raised to the
   pass's longest neighbour-cell run (no overflow) against #11 on the same
   inputs (counts equal on >= 99.9% of valid hitpoints and fewer on
   none, the rest the hash's collision double counts; flux within rtol
   1e-4 / atol 1e-6 where they are equal, at least #11's where the count
   is higher); ``--tier hash`` through the CLI, 3 passes.
19. Sharded renders (``parallel/shard.py``): two gloo ranks on the one
   card, spawned with ``torch.multiprocessing`` (NCCL refuses two ranks
   on one device), each rank's kernels counted over each render: PT auto
   (#5) at 1080p spp 4 and BDPT fused (global RIS K = 32, spl 8: #1, #8)
   bit-equal to one process; BDPT mega tile-RIS K = 32 (#9): each rank's
   half bit-equal to ``eye_pass`` over the same window; PPM, one 512x512
   pass of 1,048,576 photons (#1, #10, #11): >= 99.9% of pixels within
   rtol 1e-5 / atol 1e-6, total energy within 1e-5; then PT on a
   one-rank NCCL mesh, bit-equal.  Wall times, each render warmed once,
   beside one process's.
20. The native runtime (``runtime/native.py``): available, its build
   seconds; phase 10's 327,680-triangle textured OBJ parsed by it and by
   the Python parser (every table equal, both times); phase 11's enclosed
   text scene parsed by it; #5's walk counts at 128x72 and the mega frame
   at 1080p spp 4 (in turns) on the enclosed mesh under the numpy and the
   native cluster layouts.
21. The sphere index on SPD's sphereflake at size factor 4 (7,381
   spheres, 2 ground triangles, 3 light balls: the benchmark's
   ``sphereflake-pt-1080p`` scene, ``synth.sphereflake_scene(4)``), on
   the indexed instances of #1, #2 and #5: #1 on the 1080p camera rays
   (t bit-equal to the brute force on every ray, the whole record on >=
   99.9%: exact ties in t go to the first sphere the walk visits) and #2
   on their shadow rays to the lights under both can-block rules
   (verdicts equal on all but 1e-5 of the rays), each counting build's
   tests equal to the walk model's on 131,072 of the lanes, each timed
   with its launches counted, and its bound from the counts; #5 against
   its plain loop at 480x270 spp 4 (pixels within rtol 1e-4 / atol 1e-5
   on >= 99%, its counting build within 0.1% of the plain counts), then
   through the CLI at 1920x1080 spp 4, tier auto (mega: one #5 launch,
   no plain version), timed, and its bound from its counting build's
   counts on that frame; sphere and box tests a walk against the linear
   loop's 7,384 (at least 10 times fewer); the wide rays its warps walked
   (``wide_walks`` over ``iterations``) and the warp steps they took
   (``wide_steps``).

The line before the last is a JSON object with one entry per kernel, whose
``launches`` are the counts of the render of the path it runs on
(``path``), with the kernel's bound: the larger of the bytes it must move
over 3.35 TB/s and the operations it must do over 67 TFLOP/s (float32
outside the tensor cores; the H100 SXM's published peaks, at 700 W), with
the operations counted per PERF.md section 6: for #1-#11 from the plain
versions' counts of their algorithm's work in this run, which the
counting builds' counters (``counts``, with ``simt`` and ``occupancy``)
must equal; #6 and #7 also carry the lane count of their plain time,
their time on unsorted rays and their per-bounce times, #4 its plain
time's lane count, #1 its times at the PPM eye loop's and the BDPT light
trace's first launch and on the big mesh's first bounce (``big_mesh``),
its device time on each launch of the split frame (``per_launch``, summed
in ``split_ms``) and of the BDPT fused exact frame (``bdpt_fused``) and
on each of the PPM eye loop's (``ppm_eye``), #2 on each of the split
frame's, #3 its time on each bounce of the fused frame (recorded, then
timed one by one) and #8 on each launch of the fused exact frame (``per_launch``),
#8 the oracle's wall times and launches (``oracle``),
``floor_ms`` #6's bound without the flat super list's box tests and #1's,
#2's, #3's, #4's and #7's floors (every cast's spheres and the boxes every
ray tests, its octant's super list; #3's and #4's with their samples,
evaluations and pdfs).  The counting builds of #1-#7, #10 and #11
(``nearest_hit_counts``, ``any_blocker_counts``,
``shade_step_counts``, ``shade_step_tex_counts``,
``render_wavefront_counts``, ``nearest_hit_stream_counts``,
``any_blocker_stream_counts``, ``photon_trace_counts``,
``gather_flux_counts``) have entries of their
own, their launches counted over their 1080p / main-pass / first-bounce
call.  ``transmittance_rgb``, ``connect_rgb`` and ``connect_sampled``
carry their time on each launch of their frame (``per_launch``, summed in
``split_ms``), ``photon_trace_tex`` its whole pass (``pass_ms``),
``ppm_eye`` and ``bdpt_light`` (which replace no TPU kernel:
``replaces`` names the XLA loop or scan) their time with the host's
enqueue (``host_ms``), ``bdpt_light`` with its instances on the enclosed
scene (``bdpt_light_super``) and the textured OBJ (``bdpt_light_tex``)
the loop's with its host (``plain_host_ms``), ``bdpt_light`` the light
side's with either (``side_ms``, ``side_loop_ms``), #1, #2 and #5 their
times, launches, counts a walk and bounds on the sphereflake
(``flake``, phase 21).  The BDPT
kernels' ``simt`` has the share of a sweep's lanes that sweep a vertex
(``sweep``).
The last line is ``{"ok": true,
"device": {...}}``.  Renders and the OBJ scenes are
written under
``path_tracing_tpu_torch/build/chip_smoke/`` (gitignored).
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "scenes" / "cornell.txt"
OUT = ROOT / "path_tracing_tpu_torch" / "build" / "chip_smoke"
W, H, SPP = 1920, 1080, 4
B = W * H                      # 2,073,600 lanes
SMALL_W, SMALL_H = 128, 72
MESH_TRIS, SMALL_MESH_TRIS = 81920, 1280
SUPER_MESH_TRIS = 17000   # 512 clusters: an icosphere of the super walk
PT_SOURCE = "path_tracing_tpu_torch/csrc/pt_kernels.cu"
BDPT_SOURCE = "path_tracing_tpu_torch/csrc/bdpt_kernels.cu"
PPM_SOURCE = "path_tracing_tpu_torch/csrc/ppm_kernels.cu"
MESH_SOURCE = "path_tracing_tpu_torch/csrc/mesh_kernels.cu"
PROBE_SOURCE = "path_tracing_tpu_torch/csrc/probe_kernels.cu"
SPL, RIS_K = 8, 32
PPM_W = PPM_H = 512
PPM_SPL = 262144          # photons a light emits a pass (4 lights: 1,048,576)
PPM_PASSES = 10
REPLACES = {
    "nearest_hit": "path_tracing_tpu/ops/pallas_intersect.py:1685",
    "any_blocker": "path_tracing_tpu/ops/pallas_intersect.py:1753",
    "shade_step": "path_tracing_tpu/ops/pallas_shade.py:917",
    "shade_step_tex": "path_tracing_tpu/ops/pallas_shade.py:1044",
    "render_wavefront": "path_tracing_tpu/ops/pallas_shade.py:1281",
    "threefry_rows": "path_tracing_tpu/ops/rng.py:60",
    "connect": "path_tracing_tpu/ops/pallas_connect.py:258",
    "bdpt_eye": "path_tracing_tpu/ops/pallas_bdpt_eye.py:231",
    "photon_trace": "path_tracing_tpu/ops/pallas_photon.py:177",
    "gather_flux": "path_tracing_tpu/ops/pallas_ppm_gather.py:503",
    "nearest_hit_stream": "path_tracing_tpu/ops/pallas_intersect.py:1596",
    "any_blocker_stream": "path_tracing_tpu/ops/pallas_intersect.py:1642",
    "onehot_fetch": "path_tracing_tpu/ops/probes.py:41",
    "transmittance_rgb": "path_tracing_tpu/ops/intersect.py:443",
    "connect_rgb": "path_tracing_tpu/ops/pallas_connect.py:258",
    "connect_sampled": "path_tracing_tpu/ops/pallas_connect.py:258",
    "photon_trace_tex": "path_tracing_tpu/ops/pallas_photon.py:177",
    "ppm_eye": "none: the XLA loop path_tracing_tpu/integrators/ppm.py:114",
    "bdpt_light":
        "none: the XLA scan path_tracing_tpu/integrators/bdpt.py:131",
}
# the rows of a kernel's other instances, and the entry each launches by
for _k, _e in (("bdpt_light_super", "bdpt_light"),
               ("bdpt_light_tex", "bdpt_light")):
    REPLACES[_k] = REPLACES[_e]
ENTRY = {"bdpt_light_super": "bdpt_light"}
for _k in ("nearest_hit", "any_blocker", "render_wavefront", "shade_step",
           "shade_step_tex", "photon_trace", "gather_flux",
           "nearest_hit_stream", "any_blocker_stream"):
    REPLACES[f"{_k}_counts"] = REPLACES[_k]
SOURCES = {"connect": BDPT_SOURCE, "bdpt_eye": BDPT_SOURCE,
           "connect_rgb": BDPT_SOURCE, "connect_sampled": BDPT_SOURCE,
           "photon_trace": PPM_SOURCE, "gather_flux": PPM_SOURCE,
           "photon_trace_tex": PPM_SOURCE, "ppm_eye": PPM_SOURCE,
           "bdpt_light": BDPT_SOURCE, "bdpt_light_super": BDPT_SOURCE,
           "bdpt_light_tex": BDPT_SOURCE,
           "photon_trace_counts": PPM_SOURCE,
           "gather_flux_counts": PPM_SOURCE,
           "nearest_hit_stream": MESH_SOURCE,
           "nearest_hit_stream_counts": MESH_SOURCE,
           "any_blocker_stream": MESH_SOURCE,
           "any_blocker_stream_counts": MESH_SOURCE,
           "onehot_fetch": PROBE_SOURCE}
# the __global__ functions of each entry, as ptxas names them
PTXAS_NAMES = ("nearest_hit_uv", "nearest_hit", "any_blocker",
               "shade_step_tex", "shade_step", "render_wavefront",
               "threefry_rows", "connect", "bdpt_eye", "photon_trace",
               "gather_flux", "nearest_hit_stream", "any_blocker_stream",
               "onehot_fetch", "transmittance_rgb", "ppm_eye", "bdpt_light")
# the kernels with a counting build (their *_counts entries)
COUNTED = ("nearest_hit_uv", "nearest_hit", "any_blocker", "connect",
           "bdpt_eye", "render_wavefront", "shade_step", "shade_step_tex",
           "photon_trace", "gather_flux", "nearest_hit_stream",
           "any_blocker_stream")
# The path whose render each kernel's launches are counted over, and the
# kernels each path must launch.  The megakernel and the per-bounce kernels
# run the nearest-hit and shadow sweeps as __device__ functions, so
# nearest_hit and any_blocker are launched on their own only by the split
# tier (and phase 3).
KERNEL_PATH = {"nearest_hit": "split", "any_blocker": "split",
               "shade_step": "fused", "shade_step_tex": "textured",
               "render_wavefront": "mega", "threefry_rows": "textured",
               "connect": "bdpt_fused", "bdpt_eye": "bdpt_mega",
               "photon_trace": "ppm", "gather_flux": "ppm", "ppm_eye": "ppm",
               "bdpt_light": "bdpt_mega", "bdpt_light_super": "big_bdpt",
               "bdpt_light_tex": "tex_bdpt",
               "nearest_hit_stream": "stream",
               "any_blocker_stream": "stream", "onehot_fetch": "probe",
               "nearest_hit_counts": "hit_counting",
               "any_blocker_counts": "shadow_counting",
               "render_wavefront_counts": "pt_counting",
               "shade_step_counts": "step_counting",
               "shade_step_tex_counts": "tex_counting",
               "photon_trace_counts": "photon_counting",
               "gather_flux_counts": "ppm_counting",
               "nearest_hit_stream_counts": "stream_counting",
               "any_blocker_stream_counts": "blocker_counting",
               "transmittance_rgb": "legacy_pt",
               "connect_rgb": "legacy_bdpt", "connect_sampled": "sampled",
               "photon_trace_tex": "tex_ppm"}
BDPT_LIGHT = ("bdpt_light", "threefry_rows")   # the light trace
PATH_KERNELS = {"mega": ("render_wavefront",),
                "fused": ("shade_step", "threefry_rows"),
                "split": ("nearest_hit", "any_blocker", "threefry_rows"),
                "textured": ("shade_step_tex", "threefry_rows"),
                "bdpt_mega": ("bdpt_eye",) + BDPT_LIGHT,
                "bdpt_exact": ("bdpt_eye",) + BDPT_LIGHT,
                "bdpt_fused": ("connect",) + BDPT_LIGHT,
                "oracle": ("connect",) + BDPT_LIGHT,
                "ppm": ("ppm_eye", "photon_trace", "gather_flux",
                        "threefry_rows"),
                "stream": ("nearest_hit_stream", "any_blocker_stream",
                           "threefry_rows"),
                "big_tex": ("shade_step_tex", "threefry_rows"),
                "big_mega": ("render_wavefront",),
                "big_ppm": ("ppm_eye", "photon_trace", "gather_flux",
                            "threefry_rows"),
                "big_bdpt": ("bdpt_eye",) + BDPT_LIGHT,
                "probe": ("onehot_fetch",),
                "hit_counting": ("nearest_hit_counts",),
                "shadow_counting": ("any_blocker_counts",),
                "pt_counting": ("render_wavefront_counts",),
                "step_counting": ("shade_step_counts",),
                "tex_counting": ("shade_step_tex_counts",),
                "photon_counting": ("photon_trace_counts",),
                "ppm_counting": ("gather_flux_counts",),
                "stream_counting": ("nearest_hit_stream_counts",),
                "blocker_counting": ("any_blocker_stream_counts",),
                "legacy_pt": ("nearest_hit", "transmittance_rgb",
                              "threefry_rows"),
                "legacy_bdpt": ("connect_rgb",) + BDPT_LIGHT,
                "legacy_ppm": ("ppm_eye", "photon_trace", "gather_flux",
                               "threefry_rows"),
                "sampled": ("connect_sampled",) + BDPT_LIGHT,
                "tex_bdpt": ("connect", "bdpt_light_tex", "threefry_rows"),
                "tex_ppm": ("ppm_eye_tex", "photon_trace_tex", "gather_flux",
                            "threefry_rows"),
                "ppm_hash": ("ppm_eye", "photon_trace", "threefry_rows"),
                "flake_mega": ("render_wavefront",)}
PIXEL_RTOL, PIXEL_ATOL = 1e-4, 1e-5
BIG_TRIS = 327680         # above MAX_RESIDENT_TRIS (the TPU's ceiling)
# the enclosed scene: the icosphere at this radius on cornell's floor
ENCLOSED_R, ENCLOSED_C = 0.35, (0.0, -0.65, -0.55)
FLAKE_LEVELS = 4          # SPD's default size factor: 7,381 spheres
FLAKE_SMALL_W, FLAKE_SMALL_H = 480, 270   # #5 against its plain loop
FLAKE_COUNT_LANES = 1 << 17   # lanes whose walks the walk model counts
ROOM_TRIS = 36            # cornell's walls and blocks
ENCLOSED_TRIS = BIG_TRIS + ROOM_TRIS
EYE_HOLD_LANES = 16384    # live lanes at most a launch, held on the big mesh
PHOTON_SUBSET = 4096      # photons of the big mesh's pass held against plain
BIG_PPM_PASSES = 3
BIG_BDPT_W, BIG_BDPT_H = 32, 18
ORACLE_W, ORACLE_SPP = 256, 16
SUBSET = 65536            # lanes at least, strided, for #6/#7's plain sweeps
PROBE_ROWS, PROBE_D = 128, (4352, 16640, 66048)   # bench.py's texprobe shapes
# The card's published peaks (H100 SXM, 700 W) and the operations counted
# per unit of work for the bounds (PERF.md section 6, "Bounds"): one ray's
# test of a sphere or light ball, of a cluster box and of a triangle; one
# BSDF sample, one BSDF evaluation, one BSDF pdf, one Threefry draw
# (integer operations, counted at the float32 rate), one hitpoint-event
# distance test and the geometry of one BDPT connection row.  The floors
# of #1-#4 and #7 count the spheres and boxes of every live ray.  #1-#11
# count the work their algorithm does,
# as the plain versions count it on the same inputs (the counting builds
# are held to those counts): the evaluations and pdfs where they run, and
# each walk's tests in the kernels' order.  So theirs bound the
# algorithm's work (the cluster walk tests walls that no segment can
# cross), not the least work the function needs.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS = dict(sphere=20, box=24, tri=50, sample=150, eval=110, pdf=60, draw=120,
           pair=8, connect=40)


def bound(nbytes: float, ops: float) -> dict:
    """A kernel's least time on the card, in ms, and what sets it."""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(b, o), bound_by="bytes" if b >= o else
                "operations", library_ms=None)


def sweep_ops(c: dict) -> int:
    """Operations of a connection sweep's counted work: every row's
    geometry, the BSDF evaluations and pdfs that ran, and every shadow
    walk's primitive tests."""
    return (c["rows"] * OPS["connect"] + c["evals"] * OPS["eval"]
            + c["pdfs"] * OPS["pdf"] + c["shadow_spheres"] * OPS["sphere"]
            + c["shadow_boxes"] * OPS["box"] + c["shadow_tris"] * OPS["tri"])


def eye_ops(c: dict) -> int:
    """#9's counted operations: its sweeps, its nearest-hit casts, a BSDF
    sample and three draws a vertex, two jitter draws a sample."""
    return (sweep_ops(c) + c["hit_spheres"] * OPS["sphere"]
            + c["hit_boxes"] * OPS["box"] + c["hit_tris"] * OPS["tri"]
            + c["vertices"] * (OPS["sample"] + 3 * OPS["draw"])
            + c["samples"] * 2 * OPS["draw"])


def walk_ops(c: dict) -> int:
    """Operations of the counted nearest-hit and shadow walks' tests."""
    return ((c["hit_spheres"] + c["shadow_spheres"]) * OPS["sphere"]
            + (c["hit_boxes"] + c["shadow_boxes"]) * OPS["box"]
            + (c["hit_tris"] + c["shadow_tris"]) * OPS["tri"])


def mega_ops(c: dict) -> int:
    """#5's counted operations (the plain loop's counts): its walks, its
    BSDF samples, NEE evaluations and pdfs, and its Threefry draws, the
    fold_in of an iteration once per iteration of the frame (its key is
    every pixel's), not once per pixel-iteration as the kernel draws it."""
    draws = c["draws"] - c["iterations"] + c["iteration_keys"]
    return (walk_ops(c) + c["bsdf_samples"] * OPS["sample"]
            + c["evals"] * OPS["eval"] + c["pdfs"] * OPS["pdf"]
            + draws * OPS["draw"])


def photon_ops(c: dict) -> int:
    """#10's counted operations (the plain loop's counts): its walks' tests,
    its BSDF samples and their draws, and a fold_in per iteration any
    photon sampled in (its key is every photon's), not one per sample as
    the kernel draws it."""
    return (c["hit_spheres"] * OPS["sphere"] + c["hit_boxes"] * OPS["box"]
            + c["hit_tris"] * OPS["tri"] + c["bsdf_samples"] * OPS["sample"]
            + (c["draws"] + c["iteration_keys"]) * OPS["draw"])


def ppm_eye_ops(c: dict) -> int:
    """``ppm_eye``'s counted operations (the eye loop's counts): its walks'
    tests, a BSDF sample a delta link, its draws, and a fold_in per
    iteration any pixel sampled in (its key is every pixel's), not one per
    sample as the kernel draws it."""
    return (c["hit_spheres"] * OPS["sphere"] + c["hit_boxes"] * OPS["box"]
            + c["hit_tris"] * OPS["tri"] + c["bsdf_samples"] * OPS["sample"]
            + (c["draws"] + c["iteration_keys"]) * OPS["draw"])


def light_ops(c: dict) -> int:
    """``bdpt_light``'s counted operations (the light loop's counts):
    ``ppm_eye_ops``'s kinds (walks' tests, BSDF samples, draws, a fold_in
    per iteration any path sampled in) and a BSDF pdf a stored surface
    vertex."""
    return ppm_eye_ops(c) + c["pdfs"] * OPS["pdf"]


def stream_ops(c: dict, supers: bool = True) -> int:
    """#6's counted operations (the plain model's counts of its walk):
    sphere tests, super, cluster and block boxes, triangles.  Without
    ``supers`` the super boxes are left out: every ray tests its octant's
    whole flat super list, which the function itself does not need."""
    return (c["spheres"] * OPS["sphere"]
            + (c["supers"] * supers + c["clusters"] + c["blocks"])
            * OPS["box"] + c["tris"] * OPS["tri"])


def lane_share(c: dict, k: str) -> float:
    """The SIMT efficiency of step ``k``: its lanes over its slots."""
    return c[f"{k}_lanes"] / max(c[f"{k}_slots"], 1)


def hold_counts(what: str, kc: dict, pc: dict, names, exact: bool) -> float:
    """A counting build's counters ``kc`` against the plain version's
    ``pc`` on ``names``: equal, or within 0.1% (a rounding flip can move a
    rare lane).  Returns the largest relative difference."""
    worst = max(abs(kc[k] - pc[k]) / max(pc[k], 1) for k in names)
    check(worst == 0 if exact else worst <= 1e-3,
          f"{what}: kernel counts {kc} against plain {pc}")
    held = "equal to" if worst == 0 else f"within {worst:.2e} of"
    print(f"[counts] {what}: {held} the plain counts "
          f"{ {k: pc[k] for k in names} }")
    return worst


def simt(c: dict) -> dict:
    """The lane efficiency of the row step, the shadow step and a shadow
    walk's triangle test, and the share of a sweep's lanes that sweep a
    vertex."""
    return {k: lane_share(c, k) for k in ("row", "shadow", "tri", "sweep")}


def bounce_bytes(lanes: int, pc: dict) -> int:
    """The bytes a bounce of #3 or #4 moves at least: each lane's state
    read (ro, rd, tp, eta, depth, last_pdf: 12 words; act, last_delta) and
    written (the radiance and that state: 15 words; alive, delta), and the
    uniforms the bounce reads (rows 0-2 for a lane's NEE, 3-5 for its BSDF
    sample; ``pc``, the plain counts of its inputs)."""
    return (lanes * (12 * 4 + 2 + 15 * 4 + 2)
            + 3 * 4 * (pc["shadow_rays"] + pc["bsdf_samples"]))


def cast_ops(pk, shadow: bool = False) -> int:
    """Operations of one ray's sphere tests and the boxes every ray tests:
    every non-empty cluster's in the flat walk, its octant's super list in
    the super walk (a shadow ray skips the light balls)."""
    boxes = pk.n_super or int((pk.cl[:, 7] > 0).sum())
    spheres = pk.ns + (0 if shadow else pk.nl)
    return spheres * OPS["sphere"] + boxes * OPS["box"]


def same_bits(a: dict, b: dict) -> bool:
    """Two bounces' outputs equal bit for bit (a NaN equals itself: a lane
    whose throughput turned invalid keeps it)."""
    return all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
               if a[k].dtype == torch.float32 else torch.equal(a[k], b[k])
               for k in b)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_label() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def phase_card() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip())
    name = torch.cuda.get_device_name(0)
    print(f"[card] {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return name


def phase_build():
    from path_tracing_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    lib = _kernels.library()
    print(f"[build] {', '.join(p.name for p in lib.paths)}: nvcc "
          f"{lib.build_seconds:.2f} s (in parallel), load "
          f"{time.perf_counter() - t0:.2f} s")
    kernel, spills, seen = None, (0, 0), set()
    for line in lib.ptxas_log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in PTXAS_NAMES
                           if re.search(rf"\d{k}_kernel", line)), None)
            if kernel in COUNTED and "_kernelILb1E" in line:
                kernel += "_counts"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            seen.add(kernel)
            print(f"[build] {kernel}: {m.group(1)} registers, spill stores "
                  f"{spills[0]} B, spill loads {spills[1]} B")
    if lib.ptxas_log:
        check(seen >= set(PTXAS_NAMES),
              f"ptxas reported no registers for {set(PTXAS_NAMES) - seen}")
    return lib


def phase_occupancy() -> dict:
    """Resident blocks and warps per SM of each BDPT kernel: #9's launch on
    cornell against the main path's K = 32 tables and the exact sweep's
    813 rows (streamed), #8's against the exact sweep's (the table resident
    in shared memory); then of #1, #2, #3, #5, #10 and #11 and their
    counting builds, of ``ppm_eye``'s two instances and of
    ``bdpt_light``'s six."""
    from path_tracing_tpu_torch.ops import cuda_bdpt_eye as ce

    occ = {}
    for what, rows in (("tile-RIS", RIS_K), ("exact", 813)):
        occ[what] = ce.occupancy(rows)
        for k, o in occ[what].items():
            if what == "tile-RIS" and not k.startswith("bdpt_eye"):
                continue    # #8 runs on the exact table (fused tier, oracle)
            print(f"[build] occupancy {k} ({what} table): "
                  f"{o['blocks_per_sm']} blocks x {o['threads']} threads = "
                  f"{o['warps_per_sm']} warps an SM, {o['registers']} "
                  f"registers, {o['local_bytes']} B local, "
                  f"{o['smem_bytes']} B shared")
            check(o["blocks_per_sm"] > 0, f"{k} cannot be resident")
    from path_tracing_tpu_torch.ops import cuda_bdpt_light as cbl
    from path_tracing_tpu_torch.ops import cuda_intersect as ci
    from path_tracing_tpu_torch.ops import cuda_photon as cp
    from path_tracing_tpu_torch.ops import cuda_ppm_eye as cpe
    from path_tracing_tpu_torch.ops import cuda_ppm_gather as cg
    from path_tracing_tpu_torch.ops import cuda_shade as cs
    from path_tracing_tpu_torch.ops import cuda_wavefront as cw

    for k, o in {**ci.occupancy(), **cs.occupancy(), **cw.occupancy(),
                 **cp.occupancy(), **cg.occupancy(), **cpe.occupancy(),
                 **cbl.occupancy()}.items():
        occ[k] = o
        print(f"[build] occupancy {k}: {o['blocks_per_sm']} blocks x "
              f"{o['threads']} threads = {o['warps_per_sm']} warps an SM, "
              f"{o['registers']} registers, {o['local_bytes']} B local, "
              f"{o['smem_bytes']} B shared")
        check(o["blocks_per_sm"] > 0, f"{k} cannot be resident")
    return occ


def share_close(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL) -> float:
    ok = torch.isclose(a.double(), b.double(), rtol=rtol, atol=atol)
    if ok.dim() > 1:
        ok = ok.all(dim=1)
    return ok.float().mean().item()


def camera_rays(cam, u):
    """Camera rays of the first wavefront iteration at W x H, (B, 3)."""
    from path_tracing_tpu_torch.scene.camera import primary_ray_dirs

    idx = torch.arange(B, dtype=torch.int32, device="cuda")
    rd = primary_ray_dirs(cam, idx % W, idx // W, u[6], u[7])
    ro = cam.eye[None].expand(B, 3).contiguous()
    return ro, rd


def fresh_state(ro, rd):
    return [ro, rd, torch.ones(B, 3, device="cuda"),
            torch.ones(B, device="cuda"),
            torch.zeros(B, dtype=torch.int32, device="cuda"),
            torch.ones(B, dtype=torch.bool, device="cuda"),
            torch.ones(B, dtype=torch.bool, device="cuda"),
            torch.ones(B, device="cuda")]


STATE = ("ro", "rd", "tp", "eta", "depth", "alive", "last_is_delta",
         "last_pdf")


def step_state(step, pk, lt, key, st, kw):
    """The state after two bounces of ``step`` from ``st``, with a third
    of the lanes woken, and the next iteration's uniforms."""
    from path_tracing_tpu_torch.ops import rng

    u = rng.uniform_rows(rng.iter_key(key, 0), B, 8, device="cuda")
    for it in (1, 2):
        out = step(pk, lt, *st, u, **kw)
        st = [out[k] for k in STATE]
        u = rng.uniform_rows(rng.iter_key(key, it), B, 8, device="cuda")
    st[5] = st[5] | (torch.arange(B, device="cuda") % 3 == 0)
    return st, u


def compare_step(name, fast, plain, pk, lt, st, u, kw, timed=True) -> dict:
    a = fast(pk, lt, *st, u, **kw)
    b = plain(pk, lt, *st, u, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for k in a:
        share = share_close(a[k], b[k])
        check(share >= 0.999, f"{name}: {k} agrees on {share:.6f}")
        err = max(err, (a[k].double() - b[k].double()).abs().max().item())
    print(f"[kernels] {name} on {B} lanes ({st[5].float().mean().item():.3f}"
          f" active): every output within rtol 1e-4 / atol 1e-5 on >= 99.9%")
    if not timed:
        return dict(name=name, max_abs_err=err)
    ms = time_ms(lambda: fast(pk, lt, *st, u, **kw), 10)
    plain_ms = time_ms(lambda: plain(pk, lt, *st, u, **kw), 3)
    return dict(name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms)


def compare_hits(pk, ro, rd, with_uv: bool, what: str) -> float:
    from path_tracing_tpu_torch.ops import cuda_intersect as ci
    from path_tracing_tpu_torch.ops.intersect import INF

    a = ci.nearest_hit(pk, ro, rd, with_uv=with_uv)
    b = ci.nearest_hit_plain(pk, ro, rd, with_uv=with_uv)
    torch.cuda.synchronize()
    check(torch.equal(a["flag"], b["flag"]), f"nearest_hit {what}: flags "
          "differ")
    same = torch.isclose(a["t"], b["t"], rtol=1e-5) | (
        (a["t"] >= INF) & (b["t"] >= INF))
    share = same.float().mean().item()
    check(share >= 0.9995, f"nearest_hit {what}: t agrees on {share:.6f}")
    hit = a["flag"] > 0
    fields = ci.HIT_FIELDS + (ci.UV_FIELDS if with_uv else ())
    err = max((a[f] - b[f])[hit].abs().max().item() for f in fields)
    msg = ""
    if with_uv:
        tri = hit & same & (b["tex"] >= 0)
        uv_ok = ((a["iu"] - b["iu"]).abs() <= 1e-5) & (
            (a["iv"] - b["iv"]).abs() <= 1e-5) & (a["tex"] == b["tex"])
        uv_share = uv_ok[tri].float().mean().item()
        check(uv_share >= 0.9995,
              f"nearest_hit {what}: iu/iv agree on {uv_share:.6f}")
        msg = f", iu/iv within 1e-5 on {uv_share:.6f} of textured hits"
    print(f"[kernels] nearest_hit {what} on {ro.shape[0]} rays: flags "
          f"equal, t within rtol 1e-5 on {share:.6f}{msg}")
    return err


def mega_small_counts(p, what: str, key) -> None:
    """#5's counting build at 128x72 spp 4 on the parsed scene ``p``: its
    image #5's bit for bit, its counters the plain loop's exactly."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.ops import cuda_wavefront as cw
    from path_tracing_tpu_torch.scene.camera import make_camera

    scene = p.to_device("cuda")
    pk = scene.packed
    lt = pk.light
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, SMALL_W, SMALL_H,
                      device="cuda")
    idx = torch.arange(SMALL_W * SMALL_H, dtype=torch.int32, device="cuda")
    args = (pk, lt, cam, idx % SMALL_W, idx // SMALL_W, SPP,
            RenderConfig(width=SMALL_W, height=SMALL_H, spp=SPP, eye_depth=4),
            key)
    img, kc = cw.render_wavefront_counts(*args)
    check(torch.equal(img, cw.render_wavefront(*args)),
          "render_wavefront_counts 128x72: its image differs")
    pc = cw.new_counts()
    cw.render_wavefront_plain(*args, counts=pc)
    hold_counts(f"render_wavefront {what} {SMALL_W}x{SMALL_H} spp {SPP} "
                f"({pk.n_super} supers)", kc, pc, cw.PLAIN_COUNTS, exact=True)


def step_small_counts(p, key) -> None:
    """#3's counting build over every bounce of a 128x72 spp 4 fused frame
    of the parsed scene ``p``: its outputs #3's bit for bit, its counters
    summed over the bounces the plain version's exactly."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators.pt import wavefront_loop
    from path_tracing_tpu_torch.ops import cuda_shade as cs
    from path_tracing_tpu_torch.ops import cuda_wavefront as cw
    from path_tracing_tpu_torch.scene.camera import make_camera

    scene = p.to_device("cuda")
    pk = scene.packed
    lt = pk.light
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, SMALL_W, SMALL_H,
                      device="cuda")
    idx = torch.arange(SMALL_W * SMALL_H, dtype=torch.int32, device="cuda")
    cfg = RenderConfig(width=SMALL_W, height=SMALL_H, spp=SPP, eye_depth=4)
    kc, pc, n = cw.new_counts(), cw.new_counts(), [0]

    def step(*args, **kw):
        out, c = cs.shade_step_counts(*args, **kw)
        ref = cs.shade_step(*args, **kw)
        check(same_bits(out, ref),
              "shade_step_counts 128x72: its outputs differ from #3's")
        cs.shade_step_plain(*args, **kw, counts=pc)
        for k in c:
            kc[k] += c[k]
        n[0] += 1
        return out

    wavefront_loop(pk, lt, cam, cfg, idx % SMALL_W, idx // SMALL_W, SPP, key,
                   0, None, step)
    hold_counts(f"shade_step cornell {SMALL_W}x{SMALL_H} spp {SPP} fused "
                f"frame ({n[0]} bounces)", kc, pc, cs.STEP_COUNTS, exact=True)


def step_main_shape(scene, cam, key, small_err: float, counts: dict) -> list:
    """#3 on the lanes of the first bounce of the fused tier's 1080p spp 4
    frame on cornell, recorded from the render: against its plain version
    (every output within rtol 1e-4 / atol 1e-5 on >= 99.9%); its counting
    build bit-equal to #3 and its counters (``STEP_COUNTS``) within 0.1% of
    the plain version's; #3's bound counted from the plain counts, beside
    its floor (every cast's spheres and boxes, the samples, evaluations and
    pdfs), and the SIMT of its walk, shade and shadow step.  Returns the
    rows of #3 and its counting build."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators.pt import render_pt
    from path_tracing_tpu_torch.ops import _kernels
    from path_tracing_tpu_torch.ops import cuda_shade as cs
    from path_tracing_tpu_torch.ops import cuda_wavefront as cw

    own, calls = cs.shade_step, []

    def record(*args, **kw):
        calls.append(([x.clone() if torch.is_tensor(x) else x for x in args],
                      kw))
        return own(*args, **kw)

    cs.shade_step = record
    try:
        render_pt(scene, cam, W, H, SPP,
                  RenderConfig(width=W, height=H, spp=SPP, eye_depth=4), key,
                  tier="fused")
    finally:
        cs.shade_step = own
    # #3 on each of the frame's bounces, each timed on its own
    per_launch = [dict(ms=time_ms(lambda a=a, k=k: cs.shade_step(*a, **k), 3),
                       active=int(a[7].sum())) for a, k in calls]
    print(f"[kernels] shade_step on each of the fused frame's "
          f"{len(per_launch)} bounces (ms / active lanes): "
          + ", ".join(f"{x['ms']:.3f} / {x['active']}" for x in per_launch)
          + f"; {sum(x['ms'] for x in per_launch):.2f} ms in all")
    (pk, lt, *st, u), kw = calls[0]
    del calls
    a = cs.shade_step(pk, lt, *st, u, **kw)
    pc = cw.new_counts()
    b, count_ms = once_ms(lambda: cs.shade_step_plain(pk, lt, *st, u, **kw,
                                                      counts=pc))
    err = small_err
    for k in a:
        share = share_close(a[k], b[k])
        check(share >= 0.999, f"shade_step first bounce: {k} agrees on "
              f"{share:.6f}")
        err = max(err, (a[k].double() - b[k].double()).abs().max().item())
    _kernels.reset_counts()
    kout, kc = cs.shade_step_counts(pk, lt, *st, u, **kw)
    counts["step_counting"] = dict(_kernels.launches)
    check(same_bits(kout, a), "shade_step_counts: its outputs differ from #3's")
    hold_counts(f"shade_step {B} lanes (the fused frame's first bounce)", kc,
                pc, cs.STEP_COUNTS, exact=False)
    nbytes = bounce_bytes(B, pc)
    bnd = bound(nbytes, walk_ops(pc) + pc["bsdf_samples"] * OPS["sample"]
                + pc["evals"] * OPS["eval"] + pc["pdfs"] * OPS["pdf"])
    floor_ms = bound(nbytes, pc["iterations"] * cast_ops(pk)
                     + pc["shadow_rays"] * cast_ops(pk, True)
                     + pc["bsdf_samples"] * OPS["sample"]
                     + pc["evals"] * OPS["eval"]
                     + pc["pdfs"] * OPS["pdf"])["bound_ms"]
    ms = time_ms(lambda: cs.shade_step(pk, lt, *st, u, **kw), 10)
    plain_ms = time_ms(lambda: cs.shade_step_plain(pk, lt, *st, u, **kw), 3)
    eff = {k: lane_share(kc, k) for k in ("walk", "shade", "shadow", "tri")}
    print(f"[kernels] shade_step on the fused frame's first bounce ({B} "
          f"lanes, {pc['iterations']} active; plain counts "
          f"{count_ms / 1e3:.1f} s): {pc['shadow_rays']} shadow rays, "
          f"{pc['bsdf_samples']} BSDF samples; tests: nearest-hit spheres "
          f"{pc['hit_spheres']}, boxes {pc['hit_boxes']}, triangles "
          f"{pc['hit_tris']}; shadow spheres {pc['shadow_spheres']}, boxes "
          f"{pc['shadow_boxes']}, triangles {pc['shadow_tris']}; SIMT walk "
          f"{eff['walk']:.4f}, shade {eff['shade']:.4f}, shadow step "
          f"{eff['shadow']:.4f}, a shadow walk's triangle test "
          f"{eff['tri']:.4f}; {ms:.3f} ms, counted bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
          f"{bnd['bound_ms'] / ms:.4f} of the kernel), floor {floor_ms:.4f} "
          "ms")
    return [dict(name="shade_step", max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, counts=kc, simt=eff, floor_ms=floor_ms,
                 per_launch=per_launch, **bnd),
            dict(name="shade_step_counts", max_abs_err=err,
                 ms=time_ms(lambda: cs.shade_step_counts(
                     pk, lt, *st, u, **kw), 3), plain_ms=count_ms, **bnd)]


def phase_kernels(scene, cam, mesh, mesh_cam, counts: dict) -> list:
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.ops import _kernels
    from path_tracing_tpu_torch.ops import cuda_intersect as ci
    from path_tracing_tpu_torch.ops import cuda_shade as cs
    from path_tracing_tpu_torch.ops import cuda_wavefront as cw
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.ops.intersect import shadow_ray

    results = []
    key = rng.fold_in(rng.prng_key(0), 0)

    # ---- Threefry table: bit-equal to the int64 torch version ----
    ik = rng.iter_key(key, 3)
    a = rng.uniform_rows(ik, B, 8, device="cuda")
    b = rng.uniform_rows_plain(ik, B, 8, device="cuda")
    check(torch.equal(a, b), "threefry_rows: draws differ from the plain "
          "version")
    print(f"[kernels] threefry_rows (8, {B}): bit-equal to the plain version")
    results.append(dict(
        name="threefry_rows", max_abs_err=(a - b).abs().max().item(),
        ms=time_ms(lambda: rng.uniform_rows(ik, B, 8, device="cuda"), 10),
        plain_ms=time_ms(
            lambda: rng.uniform_rows_plain(ik, B, 8, device="cuda"), 3),
        **bound(8 * B * 4, 8 * B * OPS["draw"])))

    pk = scene.packed
    lt = scene.packed.light
    u = rng.uniform_rows(rng.iter_key(key, 0), B, 8, device="cuda")
    ro, rd = camera_rays(cam, u)

    # ---- 1. nearest hit: random rays in the box, then the camera rays ----
    ur = rng.uniform_rows(rng.prng_key(1), 1 << 18, 6, device="cuda")
    rro = (ur[0:3].T * 1.8 - 0.9).contiguous()
    rrd = shadow_ray(torch.zeros_like(rro), (ur[3:6].T - 0.5).contiguous())[0]
    err = max(compare_hits(pk, o, d, False, "cornell")
              for o, d in ((rro, rrd), (ro, rd)))
    # (without a mask: every lane walked, one thread a lane; #1's and #2's
    # rows take their times and bounds from the split frame, phase_lanes)
    unmasked = dict(nearest_hit=dict(
        ms=time_ms(lambda: ci.nearest_hit(pk, ro, rd), 10),
        plain_ms=time_ms(lambda: ci.nearest_hit_plain(pk, ro, rd), 3)))
    results.append(dict(name="nearest_hit", max_abs_err=err))

    # ---- 2. any blocker: NEE-like shadow rays from the camera hits ----
    hit = ci.nearest_hit(pk, ro, rd)
    pos = ro + rd * hit["t"][:, None]
    nrm = torch.stack([hit["nx"], hit["ny"], hit["nz"]], -1)
    li = torch.clamp((u[0] * pk.nl).long(), max=pk.nl - 1)
    p1 = pos + nrm * 1e-4
    p2 = lt[li, 0:3] + (u[1:4].T - 0.5) * 0.1
    srd, _, md = shadow_ray(p1, p2)
    pr1 = (ur[0:3].T * 1.9 - 0.95).contiguous()
    pr2 = (ur[3:6].T * 1.9 - 0.95).contiguous()
    rsrd, _, rmd = shadow_ray(pr1, pr2)
    err = 0.0
    for rule in (True, False):
        for a1, d1, m1 in ((pr1, rsrd, rmd), (p1, srd, md)):
            a = ci.any_blocker(pk, a1, d1, m1, rule)
            b = ci.any_blocker_plain(pk, a1, d1, m1, rule)
            torch.cuda.synchronize()
            check(torch.equal(a, b),
                  f"any_blocker: verdicts differ (dielectrics_block={rule})")
            err = max(err, (a.float() - b.float()).abs().max().item())
        print(f"[kernels] any_blocker dielectrics_block={rule}: verdicts "
              f"equal on {pr1.shape[0]} random and {B} NEE rays")
    unmasked["any_blocker"] = dict(
        ms=time_ms(lambda: ci.any_blocker(pk, p1, srd, md, True), 10),
        plain_ms=time_ms(
            lambda: ci.any_blocker_plain(pk, p1, srd, md, True), 3))
    results.append(dict(name="any_blocker", max_abs_err=err))
    for k, r in unmasked.items():
        print(f"[kernels] {k} without a mask on {B} lanes: {r['ms']:.3f} ms "
              f"kernel, {r['plain_ms']:.3f} ms plain")

    # ---- 3. shade step on the state after two plain bounces; its counting
    # build over a 128x72 fused frame; then on the 1080p fused frame's
    # first bounce ----
    kw = dict(clamp_val=15.0, stub_mis=True, dielectrics_block=True)
    st, u2 = step_state(cs.shade_step_plain, pk, lt, key, fresh_state(ro, rd),
                        kw)
    r = compare_step("shade_step", cs.shade_step, cs.shade_step_plain, pk,
                     lt, st, u2, kw, timed=False)
    from path_tracing_tpu_torch.scene.parser import load_scene

    step_small_counts(load_scene(str(SCENE)), key)
    results += step_main_shape(scene, cam, key, r["max_abs_err"], counts)

    # ---- 4. the textured bounce on the 1,280-triangle icosphere ----
    mpk = mesh.packed
    mlt = mesh.packed.light
    mro, mrd = camera_rays(mesh_cam, u)
    err = compare_hits(mpk, mro, mrd, True,
                       f"with_uv ({mesh.num_triangles} tris)")
    ms = time_ms(lambda: ci.nearest_hit(mpk, mro, mrd, True), 10)
    plain_ms = time_ms(lambda: ci.nearest_hit_plain(mpk, mro, mrd, True), 3)
    print(f"[kernels] nearest_hit with_uv: {ms:.3f} ms kernel, "
          f"{plain_ms:.3f} ms plain, max abs err {err:.3g}")
    st, u2 = step_state(cs.shade_step_tex_plain, mpk, mlt, key,
                        fresh_state(mro, mrd), kw)
    r = compare_step("shade_step_tex", cs.shade_step_tex,
                     cs.shade_step_tex_plain, mpk, mlt, st, u2, kw,
                     timed=False)
    tex_small_err = max(r["max_abs_err"], err)

    # ---- 5. the megakernel's 1080p image against the plain loop, which
    # counts the kernel's work; its counting build against those counts ----
    cfg = RenderConfig(width=W, height=H, spp=SPP, eye_depth=4)
    idx = torch.arange(B, dtype=torch.int32, device="cuda")
    px, py = idx % W, idx // W
    margs = (pk, lt, cam, px, py, SPP, cfg, key)
    pc = cw.new_counts()
    a = cw.render_wavefront(*margs)
    b, count_ms = once_ms(lambda: cw.render_wavefront_plain(*margs,
                                                            counts=pc))
    share = share_close(a, b)
    rel = abs(a.mean().item() - b.mean().item()) / max(b.mean().item(), 1e-6)
    check(share >= 0.99 and rel < 1e-3,
          f"render_wavefront: {share:.6f} of pixels agree, mean rel {rel}")
    equal = (a == b).all(dim=1).float().mean().item()
    print(f"[kernels] render_wavefront {W}x{H} spp {SPP}: pixels within rtol "
          f"1e-4 / atol 1e-5 {share:.6f}, bit-equal {equal:.6f}, mean rel "
          f"diff {rel:.3g}")
    from path_tracing_tpu_torch.scene import synth

    mega_small_counts(load_scene(str(SCENE)), "cornell", key)
    mega_small_counts(synth.icosphere_scene(SUPER_MESH_TRIS),
                      f"icosphere {SUPER_MESH_TRIS}", key)
    _kernels.reset_counts()
    a_c, kc = cw.render_wavefront_counts(*margs)
    counts["pt_counting"] = dict(_kernels.launches)
    check(torch.equal(a_c, a), "render_wavefront_counts: its image differs "
          "from render_wavefront's")
    hold_counts(f"render_wavefront {W}x{H} spp {SPP}", kc, pc,
                cw.PLAIN_COUNTS, exact=False)
    bnd = bound(B * (8 + 12), mega_ops(pc))
    ms = time_ms(lambda: cw.render_wavefront(*margs), 10)
    eff = {k: lane_share(kc, k) for k in ("walk", "shade", "shadow", "tri")}
    print(f"[kernels] render_wavefront counts: {pc['iterations']} iterations"
          f", {pc['samples']} paths, {pc['shadow_rays']} shadow rays, "
          f"{pc['bsdf_samples']} BSDF samples, {pc['draws']} draws (the "
          f"bound's fold_ins: {pc['iteration_keys']}); tests: "
          f"nearest-hit spheres {pc['hit_spheres']}, boxes {pc['hit_boxes']}"
          f", triangles {pc['hit_tris']}; shadow spheres "
          f"{pc['shadow_spheres']}, boxes {pc['shadow_boxes']}, triangles "
          f"{pc['shadow_tris']}; SIMT walk {eff['walk']:.4f}, shade "
          f"{eff['shade']:.4f}, shadow step {eff['shadow']:.4f}, a shadow "
          f"walk's triangle test {eff['tri']:.4f}; busy lane-iterations "
          f"{kc['iterations'] / kc['warp_iter_slots']:.4f} of each warp's "
          f"(one thread a pixel: "
          f"{pc['iterations'] / pc['pixel_warp_slots']:.4f}); counted bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
          f"{bnd['bound_ms'] / ms:.4f} of the kernel's {ms:.3f} ms")
    simt_pt = dict(eff, busy=kc["iterations"] / kc["warp_iter_slots"],
                   busy_one_thread_a_pixel=pc["iterations"]
                   / pc["pixel_warp_slots"])
    results.append(dict(name="render_wavefront",
                        max_abs_err=(a - b).abs().max().item(), ms=ms,
                        plain_ms=time_ms(lambda: cw.render_wavefront_plain(
                            *margs), 1), counts=kc, simt=simt_pt, **bnd))
    results.append(dict(name="render_wavefront_counts",
                        max_abs_err=(a_c - b).abs().max().item(),
                        ms=time_ms(lambda: cw.render_wavefront_counts(*margs),
                                   3), plain_ms=count_ms, **bnd))

    for r in results:
        check(math.isfinite(r["max_abs_err"]),
              f"{r['name']}: max abs err {r['max_abs_err']}")
        if "ms" in r:
            print(f"[kernels] {r['name']}: {r['ms']:.3f} ms kernel, "
                  f"{r['plain_ms']:.3f} ms plain, max abs err "
                  f"{r['max_abs_err']:.3g}")
    return results, tex_small_err


def run_cli(inp, w, h, tier, name, mode="pt", extra=(), spp=SPP,
            device="cuda"):
    from path_tracing_tpu_torch import cli

    out = OUT / f"{name}.png"
    res = cli.run(["--input", str(inp), "--mode", mode, "--spp", str(spp),
                   "--width", str(w), "--height", str(h), "--eye-depth", "4",
                   "--device", device, "--tier", tier, "--output", str(out),
                   *extra])
    img = res["image"]
    check(img.shape == (w * h, 3), f"{name}: image shape {img.shape}")
    check(bool((img == img).all()) and bool(abs(img).max() < float("inf")),
          f"{name}: image is not finite")
    check(img.mean() > 0.0, f"{name}: image mean {img.mean()}")
    if mode == "ppm":
        sec, n = res["seconds"], res["iters"]
        print(f"[render] {name}: ppm {w}x{h} {res['photons']} photons in {n}"
              f" passes, {res['tier']} tier {sec:.3f} s, "
              f"{res['photons'] / sec / 1e6:.3f} Mphotons/s, "
              f"{sec * 1e3 / n:.2f} ms per pass, "
              f"{w * h * n / sec / 1e6:.3f} Mpaths/s, mean {img.mean():.6f}")
        return res
    mpaths = w * h * spp * res["iters"] / res["seconds"] / 1e6
    print(f"[render] {name}: {mode} {w}x{h} spp {spp} {res['tier']} tier "
          f"{res['seconds']:.3f} s, {mpaths:.3f} Mpaths/s, mean "
          f"{img.mean():.6f}")
    return res


def counted(path, inp, w, h, tier, name, counts, mode="pt", extra=(),
            **kw):
    """Render through the CLI with the counts reset just before and read
    just after; the path's kernels must launch and no plain version run."""
    from path_tracing_tpu_torch.ops import _kernels

    _kernels.reset_counts()
    res = run_cli(inp, w, h, tier, name, mode, extra, **kw)
    launches = dict(_kernels.launches)
    plain = dict(_kernels.plain_calls)
    print(f"[render] {path} path launches {launches}, plain calls {plain}")
    check(sum(plain.values()) == 0, f"{path}: plain versions ran: {plain}")
    for k in PATH_KERNELS[path]:
        check(launches[k] > 0, f"kernel {k} was not launched by the {path} "
              "path")
    counts[path] = launches
    return res


def compare(a, b, what: str, pixel_share: float = 0.99) -> None:
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    rel = abs(a.mean() - b.mean()) / max(abs(a.mean()), 1e-6)
    close = np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(
        axis=1).mean()
    equal = (a == b).all(axis=1).mean()
    print(f"[render] {what}: mean rel diff {rel:.3g}, pixels within "
          f"rtol 1e-4 / atol 1e-5: {close:.6f}, bit-equal: {equal:.6f}")
    check(rel < 1e-3, f"{what}: mean differs by {rel}")
    check(close >= pixel_share, f"{what}: only {close} of pixels agree")


def small_tiers(scene_src, tiers, what):
    """128x72 spp 4 in the kernel tiers against the plain tier, same key."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators.pt import render_pt
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.scene.camera import make_camera

    scene = scene_src.to_device("cuda")
    cam = make_camera(scene_src.eye, scene_src.look_at, scene_src.view_up,
                      scene_src.fov, SMALL_W, SMALL_H, device="cuda")
    cfg = RenderConfig(width=SMALL_W, height=SMALL_H, spp=SPP, eye_depth=4)
    key = rng.fold_in(rng.prng_key(0), 0)
    imgs = {t: render_pt(scene, cam, SMALL_W, SMALL_H, SPP, cfg, key,
                         tier=t).cpu().numpy()
            for t in (*tiers, "plain")}
    for t in tiers:
        compare(imgs["plain"], imgs[t], f"{what} 128x72 {t} vs plain")


def phase_render(counts: dict) -> tuple:
    """The PT tiers on cornell; returns the #1 and #2 launches of the
    1080p split frame and of the 128x72 one, recorded as the wrappers
    made them (``kernel_times.record_launches``)."""
    from path_tracing_tpu_torch.kernel_times import record_launches
    from path_tracing_tpu_torch.scene.parser import load_scene

    OUT.mkdir(parents=True, exist_ok=True)
    run_cli(SCENE, SMALL_W, SMALL_H, "auto", "warmup")

    # ---- the main path: the CLI's default tier, the megakernel ----
    mega = counted("mega", SCENE, W, H, "auto", "pt_1080p_mega", counts)
    check(mega["tier"] == "mega", f"auto picked {mega['tier']} on cornell")
    check(counts["mega"]["render_wavefront"] == 1
          and counts["mega"]["shade_step"] == 0,
          f"mega path launches {counts['mega']}")
    fused = counted("fused", SCENE, W, H, "fused", "pt_1080p_fused", counts)
    split, launches = record_launches(lambda: counted(
        "split", SCENE, W, H, "split", "pt_1080p_split", counts))
    compare(fused["image"], mega["image"], "1080p mega vs fused", 0.999)
    compare(fused["image"], split["image"], "1080p split vs fused")
    _, small = record_launches(lambda: small_tiers(
        load_scene(str(SCENE)), ("mega", "fused", "split"), "cornell"))
    return launches, small


HIT_ROWS = 11   # #1's record: 10 float rows and the flag
WALK_KEYS = {"nearest_hit": ("hit_spheres", "hit_boxes", "hit_tris"),
             "any_blocker": ("shadow_spheres", "shadow_boxes",
                             "shadow_tris")}


def same_launch(name: str, a, b) -> bool:
    """#1's fields or #2's verdicts equal bit for bit on every lane."""
    return torch.equal(a, b) if name == "any_blocker" else same_bits(a, b)


def thin(live: torch.Tensor, n: int) -> torch.Tensor:
    """``live`` with every k-th live lane kept, so that at most ``n``
    stay live."""
    idx = live.nonzero().squeeze(1)
    if idx.numel() <= n:
        return live
    out = torch.zeros_like(live)
    out[idx[::-(-idx.numel() // n)]] = True
    return out


def hold_launches(name: str, calls: list, what: str,
                  max_live: int | None = None) -> list:
    """Each recorded launch of #1 or #2 (``record_launches``' argument
    tuples) against its plain version on the same inputs, bit for bit on
    every lane (the lanes that are not live with the miss record or
    false; with ``max_live``, on the launch's rays with its live lanes
    thinned to at most that many, for the plain brute force on a big
    mesh); returns each launch's device time (graph replay of 10 calls)
    and live lanes."""
    from path_tracing_tpu_torch.kernel_times import graph_ms
    from path_tracing_tpu_torch.ops import cuda_intersect as ci

    fast, plain = getattr(ci, name), getattr(ci, f"{name}_plain")
    rows, held = [], 0
    for i, a in enumerate(calls):
        h = a if max_live is None else (*a[:-1], thin(a[-1], max_live))
        held += int(h[-1].sum())
        check(same_launch(name, fast(*h), plain(*h)),
              f"{name} {what}: launch {i} differs from its plain version")
        rows.append(dict(ms=graph_ms(lambda a=a: fast(*a), 10, 5),
                         live=int(a[-1].sum())))
    total = sum(r["ms"] for r in rows)
    print(f"[kernels] {name} on each of the {what}'s {len(rows)} launches, "
          f"every lane bit-equal to the plain version ({held} of "
          f"{sum(r['live'] for r in rows)} live lanes held; device ms / live "
          f"lanes of {calls[0][1].shape[0]}): "
          + ", ".join(f"{r['ms']:.4f} / {r['live']}" for r in rows)
          + f"; {total:.3f} ms in all")
    return rows


def lanes_bound(name: str, a: tuple, pc: dict) -> tuple:
    """#1's or #2's bound on launch ``a`` from the plain counts ``pc`` of
    its live lanes' walks: the bytes of the live lanes' rays, the mask and
    every lane's record; the walks' counted tests.  And the floor beside
    it: each live lane's spheres and the boxes every ray tests
    (``cast_ops``)."""
    pk, B, live = a[0], a[1].shape[0], int(a[-1].sum())
    if name == "nearest_hit":
        nbytes = live * 24 + B + B * 4 * (HIT_ROWS + 3 * a[3])
    else:
        nbytes = live * 28 + B + B
    floor = live * cast_ops(pk, shadow=name == "any_blocker")
    return bound(nbytes, walk_ops(pc)), bound(nbytes, floor)["bound_ms"]


def phase_lanes(split: dict, small: dict, counts: dict, rows: dict) -> list:
    """#1 and #2 on the launches of the 1080p split frame (recorded by
    ``phase_render``): each launch bit-equal to its plain version on
    every lane and timed; the counting builds on every launch of the
    128x72 split frame (outputs the kernel's bit for bit, counters summed
    the plain version's exactly) and on the 1080p frame's first launch
    (within 0.1%); each kernel's row (``rows``) takes that first launch's
    time (every lane live), its plain time and its bound counted from the
    plain counts, beside the floor, and the counting build gets a row of
    its own."""
    from path_tracing_tpu_torch.ops import _kernels
    from path_tracing_tpu_torch.ops import cuda_connect as cc
    from path_tracing_tpu_torch.ops import cuda_intersect as ci

    out = []
    for name, path in (("nearest_hit", "hit_counting"),
                       ("any_blocker", "shadow_counting")):
        fast, plain = getattr(ci, name), getattr(ci, f"{name}_plain")
        counting = getattr(ci, f"{name}_counts")
        keys = WALK_KEYS[name]
        per_launch = hold_launches(name, split[name], "1080p split frame")
        kc, pc = cc.new_counts(), cc.new_counts()
        for a in small[name]:
            o, c = counting(*a)
            check(same_launch(name, o, fast(*a)),
                  f"{name}_counts 128x72: its outputs differ from {name}'s")
            plain(*a, counts=pc)
            for k in keys:
                kc[k] += c[k]
        hold_counts(f"{name} {SMALL_W}x{SMALL_H} split frame "
                    f"({len(small[name])} launches)", kc, pc, keys, True)
        first = split[name][0]
        _kernels.reset_counts()
        o, kc = counting(*first)
        counts[path] = dict(_kernels.launches)
        check(same_launch(name, o, fast(*first)),
              f"{name}_counts: its outputs differ from {name}'s")
        pc = cc.new_counts()
        _, count_ms = once_ms(lambda: plain(*first, counts=pc))
        hold_counts(f"{name} 1080p split frame's first launch", kc, pc, keys,
                    False)
        bnd, floor_ms = lanes_bound(name, first, pc)
        ms = time_ms(lambda: fast(*first), 10)
        live = int(first[-1].sum())
        print(f"[kernels] {name} on the split frame's first launch ({live} "
              f"live of {first[1].shape[0]}): {ms:.4f} ms, counted bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
              f"{bnd['bound_ms'] / ms:.4f} of the kernel), floor "
              f"{floor_ms:.4f} ms; tests "
              f"{ {k: pc[k] for k in keys} }")
        rows[name].update(ms=ms, plain_ms=time_ms(lambda: plain(*first), 3),
                          counts={k: kc[k] for k in keys}, floor_ms=floor_ms,
                          per_launch=per_launch,
                          split_ms=sum(r["ms"] for r in per_launch), **bnd)
        out.append(dict(name=f"{name}_counts", max_abs_err=0.0,
                        ms=time_ms(lambda: counting(*first), 3),
                        plain_ms=count_ms, **bnd))
    return out


def tex_main_shape(args, kw, small_err: float, counts: dict) -> list:
    """#4 on the lanes of the textured frame's first bounce (``args``,
    recorded from the CLI's render): against its plain version on a
    strided subset of >= 65,536 lanes (every output within rtol 1e-4 /
    atol 1e-5 on >= 99.9%); its counting build bit-equal to #4 and its
    counters (``STEP_COUNTS``) equal to the plain version's exactly on the
    subset and within 0.1% on every lane; #4's bound counted from those
    plain counts, beside its floor: every cast's spheres and the boxes
    every ray tests (its octant's super list), the samples, evaluations
    and pdfs.  Returns the rows of #4 and its counting build."""
    from path_tracing_tpu_torch.ops import _kernels
    from path_tracing_tpu_torch.ops import cuda_shade as cs
    from path_tracing_tpu_torch.ops import cuda_wavefront as cw

    pk, lt, *st, u = args
    n = st[0].shape[0]
    sub = torch.arange(0, n, max(1, n // SUBSET), device="cuda")
    sst = [x[sub].contiguous() for x in st] + [u[:, sub].contiguous()]
    a = cs.shade_step_tex(pk, lt, *st, u, **kw)
    b = cs.shade_step_tex_plain(pk, lt, *sst, **kw)
    torch.cuda.synchronize()
    err = small_err
    for k in a:
        share = share_close(a[k][sub], b[k])
        check(share >= 0.999, f"shade_step_tex {MESH_TRIS} tris: {k} agrees "
              f"on {share:.6f}")
        err = max(err, (a[k][sub].double() - b[k].double()).abs().max()
                  .item())
    print(f"[textured] shade_step_tex on the first bounce's {n} lanes "
          f"({st[5].float().mean().item():.3f} active, {pk.n_super} supers):"
          f" every output within rtol 1e-4 / atol 1e-5 on >= 99.9% of "
          f"{sub.numel()} strided lanes")
    _, skc = cs.shade_step_tex_counts(pk, lt, *sst, **kw)
    spc = cw.new_counts()
    cs.shade_step_tex_plain(pk, lt, *sst, **kw, counts=spc)
    hold_counts(f"shade_step_tex {sub.numel()} strided lanes", skc, spc,
                cs.STEP_COUNTS, exact=True)
    _kernels.reset_counts()
    kout, kc = cs.shade_step_tex_counts(pk, lt, *st, u, **kw)
    counts["tex_counting"] = dict(_kernels.launches)
    check(all(torch.equal(kout[k], a[k]) for k in a),
          "shade_step_tex_counts: its outputs differ from #4's")
    pc = cw.new_counts()
    _, count_ms = once_ms(lambda: cs.shade_step_tex_plain(
        pk, lt, *st, u, **kw, counts=pc))
    hold_counts(f"shade_step_tex {n} lanes", kc, pc, cs.STEP_COUNTS,
                exact=False)
    tables = sum(x.numel() for x in (pk.sph, pk.tri, pk.uv, pk.cl, pk.sup,
                                      pk.atlas)) * 4
    nbytes = tables + bounce_bytes(n, pc)
    bnd = bound(nbytes, walk_ops(pc) + pc["bsdf_samples"] * OPS["sample"]
                + pc["evals"] * OPS["eval"] + pc["pdfs"] * OPS["pdf"])
    floor_ms = bound(nbytes, pc["iterations"] * cast_ops(pk)
                     + pc["shadow_rays"] * cast_ops(pk, True)
                     + pc["bsdf_samples"] * OPS["sample"]
                     + pc["evals"] * OPS["eval"]
                     + pc["pdfs"] * OPS["pdf"])["bound_ms"]
    ms = time_ms(lambda: cs.shade_step_tex(pk, lt, *st, u, **kw), 10)
    plain_ms = time_ms(lambda: cs.shade_step_tex_plain(pk, lt, *sst, **kw), 1)
    eff = {k: lane_share(kc, k) for k in ("walk", "shade", "shadow", "tri")}
    lanes = max(pc["iterations"], 1)
    print(f"[textured] shade_step_tex counts ({count_ms / 1e3:.1f} s for the "
          f"plain counts): {pc['iterations']} active lanes, a lane's "
          f"{pc['hit_boxes'] / lanes:.1f} boxes and "
          f"{pc['hit_tris'] / lanes:.1f} triangles, {pc['shadow_rays']} "
          f"shadow rays with {pc['shadow_boxes']} boxes and {pc['shadow_tris']} triangles, "
          f"{pc['bsdf_samples']} BSDF samples; SIMT walk {eff['walk']:.4f}, "
          f"shade {eff['shade']:.4f}, shadow step {eff['shadow']:.4f}, a "
          f"shadow walk's triangle test {eff['tri']:.4f}; {ms:.3f} ms, "
          f"counted bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
          f"{bnd['bound_ms'] / ms:.4f} of the kernel), floor "
          f"{floor_ms:.4f} ms")
    return [dict(name="shade_step_tex", max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, plain_lanes=sub.numel(), counts=kc,
                 simt=eff, floor_ms=floor_ms, **bnd),
            dict(name="shade_step_tex_counts", max_abs_err=err,
                 ms=time_ms(lambda: cs.shade_step_tex_counts(
                     pk, lt, *st, u, **kw), 3), plain_ms=count_ms, **bnd)]


def phase_textured(counts: dict, small_err: float) -> list:
    """The textured main path through the CLI with its first bounce's
    lanes recorded; #4 on them (``tex_main_shape``); then the small
    textured icosphere in the kernel tiers against the plain tier."""
    from path_tracing_tpu_torch.ops import cuda_shade as cs
    from path_tracing_tpu_torch.scene import synth

    t0 = time.perf_counter()
    obj = synth.write_obj(synth.icosphere_scene(MESH_TRIS, textured=True),
                          str(OUT / f"icosphere_{MESH_TRIS}.obj"))
    print(f"[textured] wrote {obj} in {time.perf_counter() - t0:.1f} s")
    own, first = cs.shade_step_tex, {}

    def record(*args, **kw):
        if not first:
            first.update(args=[x.clone() if torch.is_tensor(x) else x
                               for x in args], kw=kw)
        return own(*args, **kw)

    cs.shade_step_tex = record
    try:
        res = counted("textured", obj, W, H, "auto", "tex_1080p", counts)
    finally:
        cs.shade_step_tex = own
    check(res["tier"] == "fused", f"auto picked {res['tier']} on a "
          "textured scene")
    check(counts["textured"]["nearest_hit"] == 0,
          "the textured bounce took its hit from the nearest_hit kernel")
    rows = tex_main_shape(first["args"], first["kw"], small_err, counts)
    small_tiers(synth.icosphere_scene(SMALL_MESH_TRIS, textured=True),
                ("fused", "split"), f"textured icosphere {SMALL_MESH_TRIS}")
    return rows


def bdpt_frame(scene, cam, K: int):
    """The set-up of the CLI's first 1080p BDPT frame on ``scene`` (spp 4,
    spl 8, eye and light depth 4, ``--resample K``, seed 0), built by the
    integrator's own functions: the config, the frame key, the scene the
    eye pass shades, the table ``bdpt_eye`` reads with its row count, the
    lanes and the depth-0 light-hit scale."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators import bdpt
    from path_tracing_tpu_torch.ops import rng

    cfg = RenderConfig(width=W, height=H, spp=SPP, spl=SPL, eye_depth=4,
                       light_depth=4, bdpt_resample_vertices=K)
    key = rng.fold_in(rng.prng_key(0), 0)
    used, lv, scale = bdpt.light_side(scene, cfg, SPL, key)
    idx = torch.arange(B, dtype=torch.int32, device="cuda")
    px, py = idx % W, idx // W
    tab, n_valid = bdpt.light_table(used, lv, cam, cfg, px, py, key)
    return cfg, key, used, tab, n_valid, px, py, scale


def once_ms(fn):
    """``fn()`` and its wall milliseconds, the card synchronised around."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_counts(what: str, kc: dict, pc: dict) -> float:
    """A counting build's counters against the plain version's count of
    the same work (``PLAIN_COUNTS``: the walks' tests in the kernels'
    cluster order): within 0.1% (a rounding flip can move a rare lane).
    Returns the largest relative difference."""
    from path_tracing_tpu_torch.ops.cuda_connect import PLAIN_COUNTS

    worst = max(abs(kc[k] - pc[k]) / max(pc[k], 1) for k in PLAIN_COUNTS)
    check(worst <= 1e-3, f"{what}: kernel counts {kc} against plain {pc}")
    eff = simt(kc)
    print(f"[bdpt] {what} counts: within {worst:.2e} of plain "
          f"{ {k: pc[k] for k in PLAIN_COUNTS} }; SIMT row {eff['row']:.4f}, "
          f"shadow {eff['shadow']:.4f}, triangle {eff['tri']:.4f}; busy "
          f"sweep lanes {eff['sweep']:.4f}; tests: "
          "nearest-hit spheres "
          f"{kc['hit_spheres']}, boxes {kc['hit_boxes']}, triangles "
          f"{kc['hit_tris']}; shadow spheres {kc['shadow_spheres']}, boxes "
          f"{kc['shadow_boxes']}, triangles {kc['shadow_tris']}")
    return worst


def hold_eye(what: str, a, b, loose_ok: bool = False) -> str:
    """#9's image against its plain version: mean within 1e-3 and >= 99%
    of pixels within rtol 1e-4 / atol 1e-5, else (``loose_ok``, the 1080p
    frames) the JAX package's BDPT tier bar (>= 97% within 1e-3, mean
    within 5%).  Returns the bar that held."""
    share = share_close(a, b)
    mean_rel = abs(a.mean().item() - b.mean().item()) / max(
        b.mean().item(), 1e-6)
    if share >= 0.99 and mean_rel < 1e-3:
        bar = "rtol 1e-4 / atol 1e-5 on >= 99%, mean within 1e-3"
    else:
        check(loose_ok, f"bdpt_eye {what}: {share:.6f} within rtol 1e-4 / "
              f"atol 1e-5, mean rel {mean_rel}")
        loose = ((a - b).abs() / (b.abs() + 1e-3)).max(dim=1).values
        loose = (loose < 1e-3).float().mean().item()
        check(loose >= 0.97 and mean_rel < 0.05,
              f"bdpt_eye {what}: {share:.6f} within rtol 1e-4, "
              f"{loose:.6f} within 1e-3, mean rel {mean_rel}")
        bar = f"the BDPT tier bar ({loose:.6f} within 1e-3)"
    equal = (a == b).all(dim=1).float().mean().item()
    print(f"[bdpt] bdpt_eye {what}: within rtol 1e-4 / atol 1e-5 "
          f"{share:.6f}, bit-equal {equal:.6f}, mean rel {mean_rel:.3g}; "
          f"held: {bar}")
    return bar


def small_bdpt(parsed, K: int, w=SMALL_W, h=SMALL_H, spp=SPP, scene=None):
    """#9's arguments for a ``w`` x ``h`` (128x72) spp 4 BDPT frame of
    ``parsed`` (spl 8, depths 4, seed 0; ``scene``: ``parsed`` already on
    the card), as the mega tier builds them."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators import bdpt
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.scene.camera import make_camera

    scene = parsed.to_device("cuda") if scene is None else scene
    cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up, parsed.fov,
                      w, h, device="cuda")
    cfg = RenderConfig(width=w, height=h, spp=spp, spl=SPL, eye_depth=4,
                       light_depth=4, bdpt_resample_vertices=K)
    key = rng.fold_in(rng.prng_key(0), 0)
    used, lv, scale = bdpt.light_side(scene, cfg, SPL, key)
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    tab, nv = bdpt.light_table(used, lv, cam, cfg, idx % w, idx // w, key)
    return (used.packed, tab, nv, cam, idx % w, idx // w, spp, cfg,
            key, scale)


def phase_bdpt_small(parsed) -> None:
    """At 128x72 spp 4: #9 and its counting build against the plain
    version and its counts on cornell (tile-RIS K = 32 and the exact
    sweep), and #9 against its plain version on a second scene, the
    1,280-triangle icosphere."""
    from path_tracing_tpu_torch.ops import cuda_bdpt_eye as ce
    from path_tracing_tpu_torch.ops import cuda_connect as cc
    from path_tracing_tpu_torch.scene import synth

    for what, K in (("tile-RIS K=32", RIS_K), ("exact", 0)):
        args = small_bdpt(parsed, K)
        img, kc = ce.bdpt_eye_counts(*args)
        check(torch.equal(img, ce.bdpt_eye(*args)),
              f"bdpt_eye_counts {what}: its image differs from bdpt_eye's")
        pc = cc.new_counts()
        hold_eye(f"{what} 128x72 spp 4", img,
                 ce.bdpt_eye_plain(*args, counts=pc))
        check_counts(f"bdpt_eye {what} 128x72 spp 4", kc, pc)
    args = small_bdpt(synth.icosphere_scene(SMALL_MESH_TRIS), RIS_K)
    hold_eye(f"icosphere {SMALL_MESH_TRIS} tile-RIS K=32 128x72 spp 4",
             ce.bdpt_eye(*args), ce.bdpt_eye_plain(*args))
    # #8's counting build on the 128x72 frame's primary hits against its
    # exact table, a third of the lanes active
    cargs = connect_args(*small_bdpt(parsed, 0)[:4], SMALL_W, SMALL_H,
                         sparse=True)
    kw = dict(clamp_val=15.0, dielectrics_block=True)
    out, kc = cc.connect_counts(*cargs, **kw)
    check(torch.equal(out, cc.connect(*cargs, **kw)),
          "connect_counts 128x72: its sums differ from #8's")
    pc = cc.new_counts()
    cc.connect_plain(*cargs, **kw, counts=pc)
    hold_counts(f"connect {SMALL_W}x{SMALL_H} ({int(cargs[-1].sum())} active)",
                kc, pc, cc.PLAIN_COUNTS, exact=True)


def connect_args(pk, tab, n_valid, cam, w: int, h: int,
                 sparse=False) -> tuple:
    """#8's arguments on the primary hits of a w x h frame's camera rays
    (jittered by the frame key's first iteration's draws), eye_f with a
    random G; with ``sparse`` a third of the active lanes kept (as later
    iterations thin out)."""
    from path_tracing_tpu_torch.ops import cuda_intersect as ci
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.ops.intersect import hit_from_fields
    from path_tracing_tpu_torch.ops.math3 import normalize
    from path_tracing_tpu_torch.scene.camera import primary_ray_dirs

    key = rng.fold_in(rng.prng_key(0), 0)
    B = w * h
    u = rng.uniform_rows(rng.iter_key(key, 0), B, 8, device="cuda")
    idx = torch.arange(B, dtype=torch.int32, device="cuda")
    rd = primary_ray_dirs(cam, idx % w, idx // w, u[6], u[7])
    ro = cam.eye[None].expand(B, 3).contiguous()
    hit = hit_from_fields(ci.nearest_hit(pk, ro, rd), ro, rd)
    act = hit.hit & ~hit.is_light
    if sparse:
        act = act & (u[5] < 1.0 / 3.0)
    eye_f = torch.where(hit.mtl.eta > 0.0, torch.zeros_like(u[0]),
                        1e8 * (1.0 + u[0] * 4.0))
    return (pk, tab, n_valid, hit.pos, hit.normal,
            (u[1:4].T * 0.5 + 0.5).contiguous(), hit.mtl, -rd,
            normalize(cam.eye[None] - hit.pos), eye_f, act)


def phase_bdpt_kernels(parsed, cam) -> tuple:
    """#8 and #9 against their plain versions on the main path's tables,
    with their counting builds against the plain counts and the bounds
    from the counts; returns the kernels' results and #9's 1080p tile-RIS
    image (the mean over spp), which the main path's render must
    reproduce."""
    from path_tracing_tpu_torch.ops import cuda_bdpt_eye as ce
    from path_tracing_tpu_torch.ops import cuda_connect as cc

    phase_bdpt_small(parsed)
    results = []
    scene = parsed.to_device("cuda")
    _, _, used, tab, n_valid, _, _, _ = bdpt_frame(scene, cam, 0)
    pk = used.packed

    # ---- 8. connect on the 1080p primary hits, eye_f with a random G ----
    args = connect_args(pk, tab, n_valid, cam, W, H)
    act = args[-1]
    kw = dict(clamp_val=15.0, dielectrics_block=True)
    a = cc.connect(*args, **kw)
    pc = cc.new_counts()
    b, plain_ms = once_ms(lambda: cc.connect_plain(*args, **kw, counts=pc))
    rel = ((a - b).abs() / (b.abs() + 1e-3)).max(dim=1).values[act]
    check(bool((rel < 1e-3).all()),
          f"connect: max relative error {rel.max().item()} on active lanes")
    check(bool((a[~act] == 0).all()), "connect: an inactive lane is not 0")
    equal = (a == b).all(dim=1)[act].float().mean().item()
    print(f"[bdpt] connect on {B} lanes ({act.float().mean().item():.3f} "
          f"active) against {n_valid} light vertices: max-channel relative "
          f"error {rel.max().item():.3g} < 1e-3 on every active lane, "
          f"bit-equal {equal:.6f}")
    a_c, kc = cc.connect_counts(*args, **kw)
    check(torch.equal(a_c, a), "connect_counts: its sums differ")
    check_counts("connect 1080p", kc, pc)
    results.append(dict(name="connect",
                        max_abs_err=(a - b).abs().max().item(),
                        ms=time_ms(lambda: cc.connect(*args, **kw), 3),
                        plain_ms=plain_ms, counts=kc, simt=simt(kc),
                        **bound(B * (23 * 4 + 12) + n_valid * 160,
                                sweep_ops(pc))))

    # ---- 9. bdpt_eye on the 1080p frame's tables: the exact sweep's
    # shared table (spp 1, for the plain version's time) and the main
    # path's tile-RIS tables (spp 4) ----
    err, ris_img = 0.0, None
    for what, K, spp, lo, n in (
            ("exact sweep", 0, 1, 3 * B // 8, B // 4),
            (f"tile-RIS K={RIS_K}", RIS_K, SPP, 0, B)):
        cfg, key, used, etab, env, px, py, scale = bdpt_frame(scene, cam, K)
        epk = used.packed
        eargs = (epk, etab, env, cam, px[lo:lo + n], py[lo:lo + n], spp, cfg,
                 key, scale, lo, B)
        if n < B:
            what += f" (lanes [{lo}, {lo + n}))"
        a, ms = once_ms(lambda: ce.bdpt_eye(*eargs))
        pc = cc.new_counts()
        b, plain_ms = once_ms(lambda: ce.bdpt_eye_plain(*eargs, counts=pc))
        print(f"[bdpt] bdpt_eye {what} (table {tuple(etab.shape)}, {env} "
              f"rows), {W}x{H} spp {spp}: {ms:.1f} ms kernel, "
              f"{plain_ms:.1f} ms plain")
        hold_eye(f"{what} {W}x{H} spp {spp}", a, b, loose_ok=True)
        a_c, kc = ce.bdpt_eye_counts(*eargs)
        check(torch.equal(a_c, a), f"bdpt_eye_counts {what}: its image "
              "differs")
        check_counts(f"bdpt_eye {what} {W}x{H} spp {spp}", kc, pc)
        bnd = bound(B * (8 + 12) + etab.numel() * 4, eye_ops(pc))
        print(f"[bdpt] bdpt_eye {what}: counted bound {bnd['bound_ms']:.4f} "
              f"ms ({bnd['bound_by']}), {bnd['bound_ms'] / ms:.4f} of the "
              "kernel's time")
        err = max(err, (a - b).abs().max().item())
        ris_img = a / spp
    results.append(dict(name="bdpt_eye", max_abs_err=err,
                        ms=time_ms(lambda: ce.bdpt_eye(*eargs), 3),
                        plain_ms=plain_ms, counts=kc, simt=simt(kc), **bnd))
    for r in results:
        check(math.isfinite(r["max_abs_err"]),
              f"{r['name']}: max abs err {r['max_abs_err']}")
        print(f"[bdpt] {r['name']}: {r['ms']:.3f} ms kernel, "
              f"{r['plain_ms']:.3f} ms plain, max abs err "
              f"{r['max_abs_err']:.3g}, counted bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.4f} of it")
    return results, ris_img.cpu().numpy()


def phase_bdpt_render(counts: dict, ris_img) -> tuple:
    """The BDPT main path and the exact sweep through the CLI; returns #8's
    time and active lanes on each launch of the fused exact frame, and #1's
    on each of that frame's launches (the eye pass's: the light trace is
    ``bdpt_light``), each held bit for bit against its plain version."""
    from path_tracing_tpu_torch.kernel_times import record_launches

    bdpt = ["--spl", str(SPL), "--light-depth", "4"]
    run_cli(SCENE, SMALL_W, SMALL_H, "auto", "bdpt_warmup", "bdpt",
            bdpt + ["--resample", str(RIS_K)])

    # ---- the main path: tile-local RIS in the megakernel ----
    ris = counted("bdpt_mega", SCENE, W, H, "auto", "bdpt_1080p_ris", counts,
                  "bdpt", bdpt + ["--resample", str(RIS_K)])
    check(ris["tier"] == "mega", f"auto picked {ris['tier']} for BDPT")
    check(counts["bdpt_mega"]["bdpt_eye"] == 1
          and counts["bdpt_mega"]["connect"] == 0,
          f"BDPT mega path launches {counts['bdpt_mega']}")
    compare(ris_img, ris["image"], "BDPT 1080p main path vs phase 6's "
            "bdpt_eye image", 0.999)

    # ---- the exact sweep: mega and fused from the same key ----
    exact = counted("bdpt_exact", SCENE, W, H, "mega", "bdpt_1080p_exact",
                    counts, "bdpt", bdpt + ["--resample", "0"])
    check(counts["bdpt_exact"]["connect"] == 0,
          f"BDPT exact mega launches {counts['bdpt_exact']}")
    (fused, launches), hits = record_launches(lambda: connect_launches(
        lambda: counted("bdpt_fused", SCENE, W, H, "fused",
                        "bdpt_1080p_fused", counts, "bdpt",
                        bdpt + ["--resample", "0"])))
    check(counts["bdpt_fused"]["bdpt_eye"] == 0,
          f"BDPT fused launches {counts['bdpt_fused']}")
    compare(fused["image"], exact["image"], "BDPT 1080p exact mega vs fused",
            0.999)
    print(f"[bdpt] connect on each of the fused exact frame's "
          f"{len(launches)} launches (ms / active lanes): "
          + ", ".join(f"{x['ms']:.3f} / {x['active']}" for x in launches)
          + f"; {sum(x['ms'] for x in launches):.1f} ms in all")
    return launches, hold_launches("nearest_hit", hits["nearest_hit"],
                                   "BDPT 1080p fused exact frame")


class _DeviceBools:
    """A (n,) view, as uint8, of the bools at a device pointer (the CUDA
    array interface), for reading a launch's mask from its arguments."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = dict(
            shape=(n,), typestr="|u1", data=(ptr, False), version=2)


def connect_launches(call) -> tuple:
    """``call()``'s result and, for each of #8's launches it makes, the
    kernel's device time (CUDA events around its entry, swapped into the
    library's entries for the call) and active lanes (its ``act``
    argument)."""
    from path_tracing_tpu_torch.ops import _kernels

    fns, timed = _kernels.library().fns, []
    own = fns["connect"]
    n = len(_kernels._TABLES) + 2  # the act mask and B follow 10 inputs

    def per_launch(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = own(*args)
        end.record()
        act = torch.as_tensor(_DeviceBools(args[n + 10].value, args[n + 11]),
                              device="cuda")
        timed.append((start, end, act.sum()))
        return rc

    fns["connect"] = per_launch
    try:
        res = call()
    finally:
        fns["connect"] = own
    torch.cuda.synchronize()
    return res, [dict(ms=s.elapsed_time(e), active=int(n))
                 for s, e, n in timed]


def phase_oracle(counts: dict) -> dict:
    """The deterministic BDPT ground truth through the CLI, ``--device
    oracle`` on cornell at 256x256 spp 16 (spl 8, BASELINE config 1's
    shape, seed 0): the fused tier, which launches #8 once an eye
    iteration.  Rendered twice, the images must be bit-equal; returns its
    wall times and launches, and #8's device time in a third render."""
    import numpy as np

    kw = dict(spp=ORACLE_SPP, device="oracle")
    extra = ["--spl", str(SPL)]
    imgs, ms = [], []
    for i in range(2):
        res = counted("oracle", SCENE, ORACLE_W, ORACLE_W, "auto",
                      f"oracle_{ORACLE_W}_{i}", counts, "bdpt", extra, **kw)
        check(res["tier"] == "fused" and counts["oracle"]["bdpt_eye"] == 0,
              f"--device oracle ran the {res['tier']} tier: "
              f"{counts['oracle']}")
        imgs.append(res["image"])
        ms.append(res["seconds"] * 1e3)
    # a third render with #8's launches timed (the events stay out of the
    # wall times above)
    _, launches = connect_launches(lambda: run_cli(
        SCENE, ORACLE_W, ORACLE_W, "auto", f"oracle_{ORACLE_W}_timed",
        "bdpt", extra, **kw))
    connect_ms = sum(x["ms"] for x in launches)
    check(np.array_equal(imgs[0], imgs[1]), "oracle: two renders differ")
    c = counts["oracle"]
    print(f"[oracle] --device oracle cornell {ORACLE_W}x{ORACLE_W} spp "
          f"{ORACLE_SPP} spl {SPL} through the CLI: bit-equal twice, "
          f"{ms[0]:.1f} / {ms[1]:.1f} ms, "
          f"{ORACLE_W ** 2 * ORACLE_SPP / ms[1] / 1e3:.3f} Mpaths/s, connect "
          f"launches {c['connect']} ({connect_ms:.1f} ms of device time in a "
          f"third render), nearest_hit {c['nearest_hit']}, mean "
          f"{imgs[0].mean():.6f}")
    return dict(ms=ms, launches=c["connect"], connect_ms=connect_ms)


def ppm_frame(scene, cam):
    """The set-up of the CLI's first 512x512 PPM pass on ``scene`` (seed
    0), built by the integrator's own functions: the config, the eye pass's
    direct term and hitpoints, the photons' emission and the photon key."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators import ppm
    from path_tracing_tpu_torch.ops import rng

    cfg = RenderConfig(width=PPM_W, height=PPM_H, spp=SPP, spl=PPM_SPL,
                       eye_depth=4, light_depth=4)
    key = rng.fold_in(rng.prng_key(0), 0)
    idx = torch.arange(PPM_W * PPM_H, dtype=torch.int32, device="cuda")
    direct, hp = ppm.ppm_eye_trace(scene, cam, cfg, idx % PPM_W,
                                   idx // PPM_W, rng.fold_in(key, 1))
    kp = rng.fold_in(key, 2)
    emit = ppm.photon_emission(scene, scene.num_lights * PPM_SPL, PPM_SPL, kp)
    return cfg, direct, hp, emit, kp


def phase_ppm_kernels(parsed, counts: dict) -> tuple:
    """``ppm_eye``, #10 and #11 against their plain versions on the main
    path's first pass, #11's counting build against the plain join's
    counts; returns the kernels' results and the pass's image from the
    kernels' outputs, which the main path's first pass must reproduce."""
    from path_tracing_tpu_torch.integrators import ppm
    from path_tracing_tpu_torch.kernel_times import graph_ms
    from path_tracing_tpu_torch.ops import _kernels
    from path_tracing_tpu_torch.ops import cuda_photon as cp
    from path_tracing_tpu_torch.ops import cuda_ppm_eye as ce
    from path_tracing_tpu_torch.ops import cuda_ppm_gather as cg
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.scene.camera import make_camera

    results = []
    scene = parsed.to_device("cuda")
    cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up, parsed.fov,
                      PPM_W, PPM_H, device="cuda")
    cfg, direct, hp, emit, kp = ppm_frame(scene, cam)
    pk = scene.packed
    P = emit[0].shape[0]
    targs = (pk, *emit, kp, cfg.light_depth, cfg.max_light_iters)
    tables = (pk.sph.numel() + pk.tri.numel() + pk.cl.numel()) * 4

    # ---- ppm_eye: the pass's eye pass against the loop it replaced ----
    Bp = PPM_W * PPM_H
    idx = torch.arange(Bp, dtype=torch.int32, device="cuda")
    eargs = (pk, cam, cfg, idx % PPM_W, idx // PPM_W,
             rng.fold_in(rng.fold_in(rng.prng_key(0), 0), 1))
    loop, eplain_ms = once_ms(lambda: ce.ppm_eye_plain(*eargs))
    check(same_eye_pass((direct, hp), loop),
          "ppm_eye differs from the eye loop on #1")
    pc = ce.new_counts()
    ce.ppm_eye_plain(*eargs, counts=pc)
    # px, py read (8 bytes a pixel), the direct term and the hitpoint
    # record written once (85), the scene's tables read once
    bnd = bound(Bp * (8 + 85) + tables, ppm_eye_ops(pc))
    ms = graph_ms(lambda: ce.ppm_eye(*eargs), 20)
    print(f"[ppm] ppm_eye on {Bp} pixels: bit-equal to the eye loop on "
          f"every pixel, {pc['deposits']} hitpoints; counts: {pc['links']} "
          f"chain links ({pc['links'] / Bp:.4f} a pixel), "
          f"{pc['bsdf_samples']} delta samples, {pc['draws']} draws, "
          f"{pc['hit_tris']} triangle tests, {pc['hit_boxes']} box tests; "
          f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
          f"{bnd['bound_ms'] / ms:.4f} of the kernel's {ms:.4f} ms "
          "device-only")
    results.append(dict(
        name="ppm_eye", max_abs_err=0.0, ms=ms, plain_ms=eplain_ms,
        host_ms=time_ms(lambda: ce.ppm_eye(*eargs), 10), counts=pc, **bnd))

    # ---- 10. photon_trace on the pass's photons ----
    ev, valid = cp.photon_trace(*targs)
    (ev_p, valid_p), plain_ms = once_ms(lambda: cp.photon_trace_plain(*targs))
    same = (valid == valid_p).float().mean().item()
    both = valid & valid_p
    close = torch.isclose(ev[both], ev_p[both], rtol=1e-5, atol=1e-6).all(
        dim=1).float().mean().item()
    equal = (ev[both] == ev_p[both]).all(dim=1).float().mean().item()
    check(same >= 0.9999 and close >= 0.9999,
          f"photon_trace: valid flags agree on {same:.6f} of rows, fields "
          f"on {close:.6f} of the valid ones")
    n_valid = int(valid.sum())
    print(f"[ppm] photon_trace {P} photons, {ev.shape[0]} event rows: valid "
          f"flags equal on {same:.6f} of rows, {n_valid} valid; fields within"
          f" rtol 1e-5 / atol 1e-6 on {close:.6f}, bit-equal {equal:.6f} of "
          "valid rows")
    # ---- its counting build: exact on a pass of 4 x 4,096 photons,
    # within 0.1% on the main path's pass ----
    small = (pk, *ppm.photon_emission(scene, scene.num_lights * 4096, 4096,
                                      kp), *targs[5:])
    sev, svalid, skc = cp.photon_trace_counts(*small)
    sev0, svalid0 = cp.photon_trace(*small)
    check(torch.equal(svalid, svalid0) and torch.equal(sev[svalid],
                                                       sev0[svalid]),
          "photon_trace_counts 16,384 photons: events differ from #10's")
    spc = cp.new_counts()
    cp.photon_trace_plain(*small, counts=spc)
    hold_counts("photon_trace 16,384 photons", skc, spc, cp.PLAIN_COUNTS,
                exact=True)
    _kernels.reset_counts()
    ev_c, valid_c, kc = cp.photon_trace_counts(*targs)
    counts["photon_counting"] = dict(_kernels.launches)
    check(torch.equal(valid_c, valid) and torch.equal(ev_c[valid], ev[valid]),
          "photon_trace_counts: events differ from #10's")
    pc = cp.new_counts()
    cp.photon_trace_plain(*targs, counts=pc)
    hold_counts(f"photon_trace {P} photons", kc, pc, cp.PLAIN_COUNTS,
                exact=False)
    simt_p = dict(bounce=lane_share(kc, "bounce"),
                  busy=kc["bounces"] / max(kc["warp_bounce_slots"], 1),
                  busy_one_thread_a_photon=pc["bounces"]
                  / max(pc["photon_warp_slots"], 1))
    bnd = bound(P * 37 + tables + n_valid * 48 + ev.shape[0], photon_ops(pc))
    # the wrapper makes no device round trip (the pass's key lives on the
    # host), so its time is the kernel's plus the launch
    ms = time_ms(lambda: cp.photon_trace(*targs), 10)
    print(f"[ppm] photon_trace counts: {pc['bounces']} bounces ("
          f"{pc['bounces'] / P:.3f} a photon), {pc['bsdf_samples']} samples,"
          f" {pc['deposits']} deposits, {pc['hit_tris']} triangle tests; "
          f"SIMT of the bounce step {simt_p['bounce']:.4f}, busy lanes "
          f"{simt_p['busy']:.4f} (one thread a photon "
          f"{simt_p['busy_one_thread_a_photon']:.4f}); bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
          f"{bnd['bound_ms'] / ms:.4f} of the kernel's {ms:.3f} ms")
    results.append(dict(
        name="photon_trace", max_abs_err=(ev[both] - ev_p[both]).abs().max()
        .item(), ms=ms, plain_ms=plain_ms, counts=kc,
        simt=simt_p, **bnd))
    results.append(dict(
        name="photon_trace_counts",
        max_abs_err=(ev_c[both] - ev_p[both]).abs().max().item(),
        ms=time_ms(lambda: cp.photon_trace_counts(*targs), 3),
        plain_ms=plain_ms, **bnd))

    # ---- 11. gather_flux on the pass's hitpoints and #10's events ----
    events = ppm.PhotonEvents(ev, valid)
    t, prep_ms = once_ms(lambda: cg.prepare(scene, cfg, hp, events))
    flux, count = cg.join(t)
    pc = cg.new_counts()
    (flux_p, count_p), gplain_ms = once_ms(lambda: cg.join_plain(t, pc))
    same = (count == count_p).float().mean().item()
    close = share_close(flux, flux_p, 1e-4, 1e-6)
    mean, mean_p = flux.double().mean().item(), flux_p.double().mean().item()
    rel = abs(mean - mean_p) / max(abs(mean_p), 1e-30)
    check(same >= 0.9999 and close >= 0.999 and rel <= 1e-5,
          f"gather_flux: counts agree on {same:.6f}, flux on {close:.6f}, "
          f"mean rel {rel}")
    pairs, cells, ov = t.candidate_pairs(), t.win.shape[0], int(t.overflow)
    accepted = int(count.sum())
    equal = (flux == flux_p).all(dim=1).float().mean().item()
    print(f"[ppm] gather_flux on {Bp} hitpoints ({int(hp.valid.sum())} "
          f"valid) and {n_valid} events: {cells} occupied cells, {pairs} "
          f"candidate pairs, {accepted} accepted, overflow {ov}; counts equal"
          f" on {same:.6f}, flux within rtol 1e-4 / atol 1e-6 on {close:.6f}"
          f", bit-equal {equal:.6f}"
          f", mean rel {rel:.3g}; prep {prep_ms:.1f} ms")
    check(ov == 0, f"gather_flux: overflow {ov} on the main path")
    # ---- the counting build: exact on a 128x128 eye pass against the same
    # photons, within 0.1% on the main path's pass ----
    small_cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up,
                            parsed.fov, 128, 128, device="cuda")
    sidx = torch.arange(128 * 128, dtype=torch.int32, device="cuda")
    _, shp = ppm.ppm_eye_trace(scene, small_cam, cfg, sidx % 128, sidx // 128,
                               rng.fold_in(rng.fold_in(rng.prng_key(0), 0), 1))
    ts = cg.prepare(scene, cfg, shp, events)
    sf, sc, skc = cg.join_counts(ts)
    f0, c0 = cg.join(ts)
    check(torch.equal(sf, f0) and torch.equal(sc, c0),
          "gather_flux_counts 128x128: flux or counts differ from #11's")
    spc = cg.new_counts()
    cg.join_plain(ts, spc)
    hold_counts("gather_flux 128x128 pass", skc, spc, cg.PLAIN_COUNTS,
                exact=True)
    _kernels.reset_counts()
    flux_c, count_c, kc = cg.join_counts(t)
    counts["ppm_counting"] = dict(_kernels.launches)
    check(torch.equal(flux_c, flux) and torch.equal(count_c, count),
          "gather_flux_counts: flux or counts differ from #11's")
    hold_counts(f"gather_flux {PPM_W}x{PPM_H} pass", kc, pc, cg.PLAIN_COUNTS,
                exact=False)
    items = int((t.items[:, 2] > 0).sum())
    simt_g = dict(pair=lane_share(kc, "pair"), eval=lane_share(kc, "eval"),
                  warp_pairs_max_over_mean=kc["warp_pairs_max"] * kc["warps"]
                  / max(kc["pairs"], 1), items=items,
                  staged_bytes=t.staged_bytes())
    gathered = int((t.hp_cell >= 0).sum())
    bnd = bound(gathered * 88 + Bp * 16 + min(n_valid, t.ev.shape[0]) * 48
                + cells * 72, pc["pairs"] * OPS["pair"]
                + pc["accepted"] * OPS["eval"])
    ms = time_ms(lambda: cg.join(t), 3)
    print(f"[ppm] gather_flux counts: {pc['near']} pairs past the distance "
          f"gate, {pc['facing']} past both, {pc['evals']} evaluated; SIMT "
          f"pair test {simt_g['pair']:.4f}, evaluation {simt_g['eval']:.4f}"
          f"; the largest of {kc['warps']} warps holds "
          f"{simt_g['warp_pairs_max_over_mean']:.2f}x the mean warp's pairs"
          f"; {items} work items stage {simt_g['staged_bytes']} event "
          f"bytes; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
          f"{bnd['bound_ms'] / ms:.4f} of the kernel's {ms:.3f} ms")
    results.append(dict(
        name="gather_flux", max_abs_err=(flux - flux_p).abs().max().item(),
        ms=ms, plain_ms=gplain_ms, counts=kc, simt=simt_g, **bnd))
    results.append(dict(
        name="gather_flux_counts",
        max_abs_err=(flux_c - flux_p).abs().max().item(),
        ms=time_ms(lambda: cg.join_counts(t), 3), plain_ms=gplain_ms, **bnd))
    for r in results:
        check(math.isfinite(r["max_abs_err"]),
              f"{r['name']}: max abs err {r['max_abs_err']}")
        print(f"[ppm] {r['name']}: {r['ms']:.3f} ms kernel, "
              f"{r['plain_ms']:.3f} ms plain, max abs err "
              f"{r['max_abs_err']:.3g}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    img = ppm.resolve_image(cfg, direct, hp, flux)
    return results, img.cpu().numpy()


def phase_ppm_render(counts: dict, pass0) -> None:
    extra = ["--spl", str(PPM_SPL), "--light-depth", "4"]
    one = run_cli(SCENE, PPM_W, PPM_H, "auto", "ppm_512_pass0", "ppm",
                  extra + ["--iters", "1"])
    compare(pass0, one["image"], f"PPM {PPM_W}x{PPM_H} pass 0 vs phase 8's "
            "kernels", 0.999)
    # ---- the main path: 10 passes of 1,048,576 photons ----
    res = counted("ppm", SCENE, PPM_W, PPM_H, "auto", "ppm_512_main", counts,
                  "ppm", extra + ["--iters", str(PPM_PASSES)])
    check(res["tier"] == "mega", f"auto picked {res['tier']} for PPM")
    c = counts["ppm"]
    check(c["photon_trace"] == c["gather_flux"] == c["ppm_eye"] == PPM_PASSES
          and c["nearest_hit"] == 0, f"PPM path launches {c}")


def stream_lanes(scene, cam):
    """The lanes of every iteration of the stream tier's CLI 1080p spp 4
    frame (seed 0) on ``scene``, recorded from the path itself: the
    arguments of each ``stream_hit`` call (the rays, the active lanes
    live) and ``stream_blocked`` call (the NEE shadow rays, the
    NEE-eligible lanes live), in lane order, copied as they are handed
    over.  Returns the path's streamed tables and the iterations' lanes."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators.pt import render_pt
    from path_tracing_tpu_torch.ops import cuda_stream as cst
    from path_tracing_tpu_torch.ops import rng

    hit, blocked, lanes = cst.stream_hit, cst.stream_blocked, []

    def record_hit(st, ro, rd, with_uv=False, live=None):
        lanes.append(dict(st=st, ro=ro.clone(), rd=rd.clone(),
                          live=live.clone(), with_uv=with_uv))
        return hit(st, ro, rd, with_uv=with_uv, live=live)

    def record_blocked(st, p1, rd, max_d, rule, live=None):
        lanes[-1].update(p1=p1.clone(), srd=rd.clone(), md=max_d.clone(),
                         elig=live.clone(), rule=rule)
        return blocked(st, p1, rd, max_d, rule, live=live)

    cst.stream_hit, cst.stream_blocked = record_hit, record_blocked
    try:
        render_pt(scene, cam, W, H, SPP,
                  RenderConfig(width=W, height=H, spp=SPP),
                  rng.fold_in(rng.prng_key(0), 0), tier="stream")
    finally:
        cst.stream_hit, cst.stream_blocked = hit, blocked
    check(len(lanes) >= 2 and all(
        "elig" in ln and ln["with_uv"] and ln["rule"]
        and ln["live"] is not None and ln["elig"] is not None
        for ln in lanes), "the stream render's iterations were not "
          "recorded")
    return lanes[0]["st"], lanes


def sort_lanes(st, ro, rd, live, *extras):
    """The rays (and ``extras``) in the order the path sorts them, sorted
    by ``sorted_call`` itself, and the live count it hands the kernel."""
    from path_tracing_tpu_torch.ops.intersect import sorted_call

    got = {}

    def keep(*args, n_live):
        got["args"] = [x.contiguous() for x in args]
        got["n_live"] = n_live
        return args[0]

    sorted_call(st.bounds, ro, rd, keep, *extras, live=live)
    return got["args"], got["n_live"]


def blocker_verdicts(what: str, a, b, a_sub, c) -> float:
    """#7's verdicts ``a`` against #2's ``b``, and ``a_sub`` (a subset of
    ``a``) against the plain version's ``c``, all on live lanes: equal on
    >= 99.99% of lanes with mismatches at most 1% of the reference's
    blocked lanes, and between 5% and 95% of the lanes blocked, so that
    the comparison has occlusions to lose.  Returns the largest
    difference."""
    out = 0.0
    for ref_name, x, ref in (("#2", a, b), ("plain", a_sub, c)):
        n, nb = ref.numel(), int(ref.sum())
        miss = int((x != ref).sum())
        share = nb / max(n, 1)
        print(f"[mesh] any_blocker_stream {what} vs {ref_name}: {n} lanes, "
              f"{nb} blocked ({share:.4f}), {miss} verdicts differ")
        check(0.05 < share < 0.95 and miss <= 0.01 * nb
              and miss <= 1e-4 * n,
              f"any_blocker_stream {what} vs {ref_name}: {miss} of {n} "
              f"verdicts differ, {nb} blocked")
        out = max(out, float(miss > 0))
    return out


def stream_counts(st, sro, srd, n_live, sub, counts: dict) -> dict:
    """#6's counting build on the stream frame's first bounce (sorted, as
    the path runs it): its (t, idx, kind) #6's bit for bit, its counters
    the plain model's (``_count_stream_walk``) exactly on the strided
    subset's live lanes and within 0.1% on every live lane, with the
    triangle test's SIMT; #6's bound from the model's counts of the frame.
    Returns the results of #6 and its counting build (times to come)."""
    from path_tracing_tpu_torch.ops import _kernels
    from path_tracing_tpu_torch.ops import cuda_stream as cst

    nl = int(n_live)
    sl = sub[sub < nl]
    *kk, skc = cst.nearest_hit_stream_counts(st, sro[sl], srd[sl])
    spc = cst.new_counts()
    t_model = cst._count_stream_walk(st, sro[sl], srd[sl], spc)
    check(torch.equal(t_model, kk[0]), "the walk model's t differs from "
          "#6's on the subset")
    hold_counts(f"nearest_hit_stream {sl.numel()} strided live lanes", skc,
                spc, cst.PLAIN_COUNTS, exact=True)
    _kernels.reset_counts()
    *kk, kc = cst.nearest_hit_stream_counts(st, sro, srd, n_live)
    counts["stream_counting"] = dict(_kernels.launches)
    check(all(torch.equal(a, b) for a, b in zip(
        kk, cst.nearest_hit_stream(st, sro, srd, n_live))),
          "nearest_hit_stream_counts: (t, idx, kind) differ from #6's")
    pc = cst.new_counts()
    t0 = time.perf_counter()
    cst._count_stream_walk(st, sro[:nl], srd[:nl], pc)
    model_s = time.perf_counter() - t0
    hold_counts(f"nearest_hit_stream {nl} live lanes", kc, pc,
                cst.PLAIN_COUNTS, exact=False)
    tables = sum(x.numel() for x in (st.sph, st.tri, st.cl, st.sup,
                                     st.blk)) * 4
    nbytes = tables + nl * 24 + sro.shape[0] * 12
    bnd = bound(nbytes, stream_ops(pc))
    floor_ms = bound(nbytes, stream_ops(pc, supers=False))["bound_ms"]
    simt = dict(tri=lane_share(kc, "tri"))
    print(f"[mesh] nearest_hit_stream counts ({model_s:.1f} s for the "
          f"model): {pc['supers']} super, {pc['clusters']} cluster, "
          f"{pc['blocks']} block boxes, {pc['tris']} triangle tests "
          f"({pc['tris'] / max(nl, 1):.1f} a ray); SIMT of the triangle test"
          f" {simt['tri']:.4f}; bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']}), {floor_ms:.4f} ms without the super boxes")
    return {"nearest_hit_stream": dict(name="nearest_hit_stream", counts=kc,
                                       simt=simt, floor_ms=floor_ms, **bnd),
            "nearest_hit_stream_counts": dict(
                name="nearest_hit_stream_counts",
                ms=time_ms(lambda: cst.nearest_hit_stream_counts(
                    st, sro, srd, n_live), 3), **bnd)}


def blocker_counts(st, sp1, ssrd, smd, n_elig, esub, rule,
                   counts: dict) -> dict:
    """#7's counting build on the stream frame's first NEE rays (sorted,
    as the path runs them): its verdicts #7's, its counters the plain
    model's (``_count_stream_shadow_walk``) exactly on the strided subset
    and within 0.1% on every live lane; #7's bound from the model's
    counts, beside its floor (every ray's spheres and super list).
    Returns the rows of #7 and its counting build (times to come)."""
    from path_tracing_tpu_torch.ops import _kernels
    from path_tracing_tpu_torch.ops import cuda_stream as cst

    ne = int(n_elig)
    a, skc = cst.any_blocker_stream_counts(st, sp1[esub], ssrd[esub],
                                           smd[esub], rule)
    spc = cst.new_counts()
    v = cst._count_stream_shadow_walk(st, sp1[esub], ssrd[esub], smd[esub],
                                      rule, spc)
    check(torch.equal(v, a), "the blocker model's verdicts differ from "
          "#7's on the subset")
    hold_counts(f"any_blocker_stream {esub.numel()} strided live lanes", skc,
                spc, cst.PLAIN_COUNTS, exact=True)
    _kernels.reset_counts()
    a, kc = cst.any_blocker_stream_counts(st, sp1, ssrd, smd, rule, n_elig)
    counts["blocker_counting"] = dict(_kernels.launches)
    check(torch.equal(a, cst.any_blocker_stream(st, sp1, ssrd, smd, rule,
                                                n_elig)),
          "any_blocker_stream_counts: its verdicts differ from #7's")
    pc = cst.new_counts()
    t0 = time.perf_counter()
    cst._count_stream_shadow_walk(st, sp1[:ne], ssrd[:ne], smd[:ne], rule, pc)
    model_s = time.perf_counter() - t0
    hold_counts(f"any_blocker_stream {ne} live lanes", kc, pc,
                cst.PLAIN_COUNTS, exact=False)
    tables = sum(x.numel() for x in (st.sph, st.tri, st.cl, st.sup,
                                     st.blk)) * 4
    nbytes = tables + ne * 28 + sp1.shape[0]
    bnd = bound(nbytes, stream_ops(pc))
    floor_ms = bound(nbytes, ne * (st.ns * OPS["sphere"]
                                   + st.n_super * OPS["box"]))["bound_ms"]
    print(f"[mesh] any_blocker_stream counts ({model_s:.1f} s for the "
          f"model): {pc['spheres']} sphere tests, {pc['supers']} super, "
          f"{pc['clusters']} cluster, {pc['blocks']} block boxes, "
          f"{pc['tris']} triangle tests ({pc['tris'] / max(ne, 1):.1f} a "
          f"ray), {int(a[:ne].sum())} of {ne} blocked; bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), floor "
          f"{floor_ms:.4f} ms")
    return {"any_blocker_stream": dict(name="any_blocker_stream", counts=kc,
                                       floor_ms=floor_ms, **bnd),
            "any_blocker_stream_counts": dict(
                name="any_blocker_stream_counts",
                ms=time_ms(lambda: cst.any_blocker_stream_counts(
                    st, sp1, ssrd, smd, rule, n_elig), 3), **bnd)}


def per_bounce(st, lanes, res: dict) -> None:
    """#6's and #7's times on each iteration's sorted lanes of the stream
    frame, beside the live count each is handed."""
    from path_tracing_tpu_torch.ops import cuda_stream as cst

    for name in ("nearest_hit_stream", "any_blocker_stream"):
        res[name]["per_bounce"] = []
    for it, ln in enumerate(lanes):
        (sro, srd), n_live = sort_lanes(st, ln["ro"], ln["rd"], ln["live"])
        (sp1, ssrd, smd), n_elig = sort_lanes(st, ln["p1"], ln["srd"],
                                              ln["elig"], ln["md"])
        rows = (("nearest_hit_stream", int(n_live), time_ms(
                    lambda: cst.nearest_hit_stream(st, sro, srd, n_live), 5)),
                ("any_blocker_stream", int(n_elig), time_ms(
                    lambda: cst.any_blocker_stream(st, sp1, ssrd, smd,
                                                   ln["rule"], n_elig), 5)))
        for name, n, ms in rows:
            res[name]["per_bounce"].append(dict(n_live=n, ms=ms))
        print(f"[mesh] bounce {it}: nearest_hit_stream {rows[0][2]:.4f} ms "
              f"on {rows[0][1]} live lanes, any_blocker_stream "
              f"{rows[1][2]:.4f} ms on {rows[1][1]}")
    for name in ("nearest_hit_stream", "any_blocker_stream"):
        pb = res[name]["per_bounce"]
        print(f"[mesh] {name} over the frame's {len(pb)} iterations: "
              f"{sum(r['ms'] for r in pb):.3f} ms "
              f"(mean {sum(r['ms'] for r in pb) / len(pb):.4f})")


def same_eye_pass(a, b) -> bool:
    """Two eye passes' outputs are equal bit for bit."""
    from path_tracing_tpu_torch.ops.cuda_ppm_eye import eye_pass_bits

    return torch.equal(eye_pass_bits(a), eye_pass_bits(b))


def through_light_loop(call):
    """``call()`` with the BDPT light trace run by its loop
    (``light_trace_plain`` on #1 and ``threefry_rows``), as every tier ran
    it before ``bdpt_light``."""
    from path_tracing_tpu_torch.integrators import bdpt
    from path_tracing_tpu_torch.ops import cuda_bdpt_light as cbl

    own, bdpt.light_trace = bdpt.light_trace, cbl.light_trace_plain
    try:
        return call()
    finally:
        bdpt.light_trace = own


def hold_light(scene, name: str, what: str) -> tuple:
    """``bdpt_light``'s instance ``name`` on the light trace of the 1080p
    BDPT frame on ``scene`` (a device scene; spl 8, light depth 4, the
    first frame of seed 0), its arguments recorded from ``light_side``:
    every field of every vertex bit-equal to the loop it replaced
    (``light_trace_plain`` on #1), the kernel timed device-only (graph
    replay) and with the host's enqueue, the loop with its host.  Returns
    the kernel's row and the recorded arguments."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators import bdpt
    from path_tracing_tpu_torch.kernel_times import _recorded, graph_ms
    from path_tracing_tpu_torch.ops import cuda_bdpt_light as cbl
    from path_tracing_tpu_torch.ops import rng

    cfg = RenderConfig(width=W, height=H, spp=SPP, spl=SPL, eye_depth=4,
                       light_depth=4, bdpt_resample_vertices=RIS_K)
    key = rng.fold_in(rng.prng_key(0), 0)
    args = _recorded(bdpt, "light_trace", lambda: bdpt.light_side(
        scene, cfg, SPL, key))[0][0]
    lv = cbl.light_trace(*args)
    loop, plain_ms = once_ms(lambda: cbl.light_trace_plain(*args))
    check(torch.equal(cbl.light_vertex_bits(lv), cbl.light_vertex_bits(loop)),
          f"{name} differs from the light loop on #1 on {what}")
    P, L = lv.valid.shape
    row = dict(
        name=name, max_abs_err=0.0, paths=P, slots=L,
        stored=int(lv.valid[:, 1:].sum()),
        ms=graph_ms(lambda: cbl.light_trace(*args), 20),
        host_ms=time_ms(lambda: cbl.light_trace(*args), 20),
        plain_ms=plain_ms,
        plain_host_ms=time_ms(lambda: cbl.light_trace_plain(*args), 5))
    print(f"[bdpt] {name} on {what}, {P} paths x {L} slots: bit-equal to "
          f"the light loop on every vertex ({row['stored']} stored past the "
          f"emitters); {row['ms']:.4f} ms device-only (graph replay), "
          f"{row['host_ms']:.4f} ms with the host's enqueue, the loop "
          f"{row['plain_host_ms']:.3f} ms with its host")
    return row, args


def phase_bdpt_light(parsed) -> dict:
    """``bdpt_light`` on the main path's light trace (cornell, spl 8: 4 x 8
    x 8 = 256 paths, light depth 4, the first frame of seed 0) by
    ``hold_light``, its bound from the loop's count of its work (walks,
    BSDF samples, reverse pdfs, draws), and the frame's whole light side
    (emission, pack, trace) with its host through the kernel and through
    the loop."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators import bdpt
    from path_tracing_tpu_torch.ops import cuda_bdpt_light as cbl
    from path_tracing_tpu_torch.ops import rng

    scene = parsed.to_device("cuda")
    row, args = hold_light(scene, "bdpt_light", "cornell")
    pc = cbl.new_counts()
    check(torch.equal(cbl.light_vertex_bits(cbl.light_trace_plain(
        *args, counts=pc)), cbl.light_vertex_bits(cbl.light_trace(*args))),
          "bdpt_light differs from the light loop on the plain #1")
    pk, nl = args[0], args[1].num_lights
    P, L = row["paths"], row["slots"]
    tables = (pk.sph.numel() + pk.tri.numel() + pk.cl.numel()) * 4
    # the emission sample read (37 bytes a path), the lights' rows (20
    # bytes each), every vertex row written once (103 bytes), the scene's
    # tables read once
    bnd = bound(P * 37 + nl * 20 + P * L * 103 + tables,
                light_ops(pc))
    cfg = RenderConfig(width=W, height=H, spp=SPP, spl=SPL, eye_depth=4,
                       light_depth=4, bdpt_resample_vertices=RIS_K)
    key = rng.fold_in(rng.prng_key(0), 0)
    row.update(
        counts=pc, **bnd,
        side_ms=time_ms(lambda: bdpt.light_side(scene, cfg, SPL, key), 20),
        side_loop_ms=time_ms(lambda: through_light_loop(
            lambda: bdpt.light_side(scene, cfg, SPL, key)), 5))
    print(f"[bdpt] bdpt_light counts: {pc['walks']} walks, "
          f"{pc['bsdf_samples']} BSDF samples, {pc['pdfs']} reverse pdfs, "
          f"{pc['draws']} draws, {pc['hit_tris']} triangle tests, "
          f"{pc['hit_boxes']} box tests, {pc['stored']} vertices stored; "
          f"bound {bnd['bound_ms']:.6f} ms ({bnd['bound_by']}), "
          f"{bnd['bound_ms'] / row['ms']:.4%} of the kernel's "
          f"{row['ms']:.4f} ms device-only; the light side "
          f"{row['side_ms']:.3f} ms through the kernel, "
          f"{row['side_loop_ms']:.3f} ms through the loop")
    return row


def retime_nearest_hit(parsed, row: dict) -> None:
    """#1 at the shapes its main paths launch it on, recorded from the
    integrators' own calls: every launch of the PPM eye loop on #1 (the
    first 512x512 pass of cornell, 262,144 rays), each held bit for bit
    against its plain version and timed device-only (CUDA-graph replay),
    the ``ppm_eye`` kernel's outputs held bit for bit against the loop's,
    and the first launch of the BDPT light loop as it ran before
    ``bdpt_light`` (the 1080p frame's, spl 8; ``light_trace_plain`` on
    #1); adds each first launch's time (device-only, and with the host's
    enqueue), lane count and bound to #1's row."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators import bdpt
    from path_tracing_tpu_torch.kernel_times import graph_ms, record_launches
    from path_tracing_tpu_torch.ops import cuda_intersect as ci
    from path_tracing_tpu_torch.ops import cuda_ppm_eye as ce
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.scene.camera import make_camera

    scene = parsed.to_device("cuda")
    cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up, parsed.fov,
                      PPM_W, PPM_H, device="cuda")
    key = rng.fold_in(rng.prng_key(0), 0)
    idx = torch.arange(PPM_W * PPM_H, dtype=torch.int32, device="cuda")
    ppm_cfg = RenderConfig(width=PPM_W, height=PPM_H, spp=SPP, spl=PPM_SPL,
                           eye_depth=4, light_depth=4)
    bdpt_cfg = RenderConfig(width=W, height=H, spp=SPP, spl=SPL, eye_depth=4,
                            light_depth=4, bdpt_resample_vertices=RIS_K)
    eye_args = (scene.packed, cam, ppm_cfg, idx % PPM_W,
                idx // PPM_W, rng.fold_in(key, 1))
    for what, call in (
            ("ppm_eye", lambda: ce.ppm_eye_plain(*eye_args)),
            ("bdpt_light", lambda: through_light_loop(
                lambda: bdpt.light_side(scene, bdpt_cfg, SPL, key)))):
        res, rec = record_launches(call)
        calls = rec["nearest_hit"]
        if what == "ppm_eye":
            check(same_eye_pass(ce.ppm_eye(*eye_args), res),
                  "ppm_eye differs from the eye loop on #1")
        a = calls[0]
        pk, n = a[0], a[1].shape[0]
        row[what] = dict(
            rays=n, live=int(a[-1].sum()),
            ms=graph_ms(lambda: ci.nearest_hit(*a), 20),
            host_ms=time_ms(lambda: ci.nearest_hit(*a), 20),
            **bound(n * (24 + 1 + HIT_ROWS * 4), n * cast_ops(pk)))
        if what == "ppm_eye":
            row[what]["per_launch"] = hold_launches(
                "nearest_hit", calls, f"{PPM_W}x{PPM_H} PPM eye pass")
        print(f"[kernels] nearest_hit on the {what} path's first launch: "
              f"{n} rays, {row[what]['ms']:.4f} ms device-only (graph "
              f"replay), {row[what]['host_ms']:.4f} ms a call with the host,"
              f" bound {row[what]['bound_ms']:.5f} ms "
              f"({row[what]['bound_by']})")


def phase_mesh_kernels(counts: dict, mesh) -> tuple:
    """#6 and #7 on the stream tier's lanes of the 327,680-triangle
    textured frame (``mesh``), against #1/#2 on every live lane and their
    plain versions on a strided subset, with their times on sorted and
    unsorted rays, and #7 on random shadow segments through the mesh; #12
    at the probe's shapes.  Writes the frame's OBJ; returns the results and
    its path."""
    from path_tracing_tpu_torch.kernel_times import graph_ms, shadow_segments
    from path_tracing_tpu_torch.ops import _kernels
    from path_tracing_tpu_torch.ops import cuda_intersect as ci
    from path_tracing_tpu_torch.ops import cuda_stream as cst
    from path_tracing_tpu_torch.ops import probes
    from path_tracing_tpu_torch.scene import synth
    from path_tracing_tpu_torch.scene.camera import make_camera
    from path_tracing_tpu_torch.scene.obj_loader import load_any_scene

    t0 = time.perf_counter()
    obj = synth.write_obj(mesh, str(OUT / f"icosphere_{BIG_TRIS}.obj"))
    t1 = time.perf_counter()
    parsed = load_any_scene(obj)
    t2 = time.perf_counter()
    scene = parsed.to_device("cuda")
    print(f"[mesh] {BIG_TRIS}-triangle textured icosphere: OBJ write "
          f"{t1 - t0:.1f} s, OBJ parse {t2 - t1:.1f} s, to the card "
          f"{time.perf_counter() - t2:.1f} s")
    cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up, parsed.fov,
                      W, H, device="cuda")
    st, lanes = stream_lanes(scene, cam)
    pk = scene.packed
    print(f"[mesh] streamed tables: Tp {st.tri.shape[0]}, {st.cl.shape[0]} "
          f"cluster rows, {st.n_super} supers, {st.blk.shape[0]} blocks")
    sub = torch.arange(0, B, B // SUBSET, device="cuda")
    hit_err, blk_err, res = 0.0, 0.0, {}
    for it, ln in enumerate(lanes[:2]):
        (sro, srd), n_live = sort_lanes(st, ln["ro"], ln["rd"], ln["live"])
        nl = int(n_live)        # the live lanes sort first
        uro, urd = (x[ln["live"]].contiguous() for x in (ln["ro"], ln["rd"]))
        # ---- 6 against #1 on every lane, both with_uv ----
        raw = cst.nearest_hit_stream(st, sro, srd)
        a = cst.resolve_stream_attrs(st, *raw, sro, srd, with_uv=True)
        b = ci.nearest_hit(pk, sro, srd, with_uv=True)
        torch.cuda.synchronize()
        flag = (a["flag"] == b["flag"]).float().mean().item()
        t_eq = (a["t"] == b["t"]).float().mean().item()
        tri = (a["flag"] == 1) & (b["flag"] == 1) & (a["t"] == b["t"])
        same = tri & (a["nx"] == b["nx"]) & (a["ny"] == b["ny"]) & (
            a["nz"] == b["nz"])
        fields_eq = all(bool((a[k] == b[k])[same].all()) for k in (
            "bcr", "bcg", "bcb", "rough", "metal", "eta", "tex"))
        uv_ok = ((a["iu"] - b["iu"]).abs() <= 1e-5) & (
            (a["iv"] - b["iv"]).abs() <= 1e-5)
        uv = uv_ok[tri].float().mean().item()
        check(flag >= 0.9999 and t_eq >= 0.9995 and fields_eq and uv >= 0.999,
              f"nearest_hit_stream bounce {it}: flags {flag}, t {t_eq}, "
              f"fields {fields_eq}, iu/iv {uv}")
        hit_err = max(hit_err, (a["t"] - b["t"])[tri].abs().max().item())
        # ---- 6 against its plain version on the strided subset ----
        p = cst.nearest_hit_stream_plain(st, sro[sub], srd[sub])
        k = [x[sub] for x in raw]
        kind_eq = (k[2] == p[2]).float().mean().item()
        tp_eq = (k[0] == p[0]).float().mean().item()
        idx_eq = (k[1] == p[1]).float().mean().item()
        check(kind_eq >= 0.9999 and tp_eq >= 0.9995 and idx_eq >= 0.9995,
              f"nearest_hit_stream bounce {it} vs plain: kind {kind_eq}, "
              f"t {tp_eq}, idx {idx_eq}")
        print(f"[mesh] nearest_hit_stream bounce {it} ({nl} live of"
              f" {B}, {tri.float().mean().item():.4f} triangle hits): vs #1 "
              f"flags {flag:.6f}, t bit-equal {t_eq:.6f}, the same triangle "
              f"on {same.sum().item() / max(tri.sum().item(), 1):.6f} of "
              f"equal-t hits, its fields equal, iu/iv within 1e-5 {uv:.6f};"
              f" vs plain on {sub.numel()} lanes kind {kind_eq:.6f}, t "
              f"{tp_eq:.6f}, idx {idx_eq:.6f}")
        ms_s = time_ms(lambda: cst.nearest_hit_stream(st, sro, srd, n_live),
                       5)
        ms_u = time_ms(lambda: cst.nearest_hit_stream(st, uro, urd), 5)
        ms_1 = time_ms(lambda: ci.nearest_hit(pk, sro[:nl], srd[:nl]), 5)
        _, plain_ms = once_ms(lambda: cst.nearest_hit_stream_plain(
            st, sro[sub], srd[sub]))
        print(f"[mesh] nearest_hit_stream bounce {it}: {ms_s:.3f} ms sorted, "
              f"{ms_u:.3f} ms unsorted; #1 {ms_1:.3f} ms; plain "
              f"{plain_ms:.1f} ms on {sub.numel()} lanes")
        if it == 0:
            res.update(stream_counts(st, sro, srd, n_live, sub, counts))
            res["nearest_hit_stream"].update(
                ms=ms_s, plain_ms=plain_ms, plain_lanes=sub.numel(),
                unsorted_ms=ms_u)
            res["nearest_hit_stream_counts"]["plain_ms"] = plain_ms
            big = dict(rays=nl, ms=ms_1, stream_ms=ms_s,
                       supers=pk.n_super)
        # ---- 7 against #2 and its plain version on the NEE lanes ----
        (sp1, ssrd, smd), n_elig = sort_lanes(st, ln["p1"], ln["srd"],
                                              ln["elig"], ln["md"])
        ne = int(n_elig)        # the NEE-eligible lanes sort first
        esub = torch.arange(0, ne, max(1, ne // SUBSET), device="cuda")
        for rule in (True, False):
            a = cst.any_blocker_stream(st, sp1, ssrd, smd, rule, n_elig)
            b = ci.any_blocker(pk, sp1[:ne], ssrd[:ne], smd[:ne], rule)
            c = cst.any_blocker_stream_plain(st, sp1[esub], ssrd[esub],
                                             smd[esub], rule)
            torch.cuda.synchronize()
            check(not a[ne:].any(), f"any_blocker_stream bounce {it}: a "
                  "lane past n_live reports blocked")
            blk_err = max(blk_err, blocker_verdicts(
                f"bounce {it} NEE lanes dielectrics_block={rule}", a[:ne], b,
                a[esub], c))
        ms_s = time_ms(lambda: cst.any_blocker_stream(st, sp1, ssrd, smd, True,
                                                      n_elig), 5)
        up1, usrd, umd = (x[ln["elig"]].contiguous()
                          for x in (ln["p1"], ln["srd"], ln["md"]))
        ms_u = time_ms(lambda: cst.any_blocker_stream(st, up1, usrd, umd,
                                                      True), 5)
        ms_2 = time_ms(lambda: ci.any_blocker(pk, sp1[:ne], ssrd[:ne],
                                              smd[:ne], True), 5)
        _, plain_ms = once_ms(lambda: cst.any_blocker_stream_plain(
            st, sp1[esub], ssrd[esub], smd[esub], True))
        print(f"[mesh] any_blocker_stream bounce {it}: {ms_s:.3f} ms sorted, "
              f"{ms_u:.3f} ms unsorted; #2 {ms_2:.3f} ms; plain "
              f"{plain_ms:.1f} ms on {esub.numel()} lanes")
        if it == 0:
            res.update(blocker_counts(st, sp1, ssrd, smd, n_elig, esub,
                                      ln["rule"], counts))
            res["any_blocker_stream"].update(
                ms=ms_s, plain_ms=plain_ms, plain_lanes=esub.numel(),
                unsorted_ms=ms_u)
            res["any_blocker_stream_counts"]["plain_ms"] = plain_ms
    # ---- 7 on random shadow segments through the mesh, every lane live
    # (the card test's recipe at full width) ----
    p1, rd, md = shadow_segments(st, B, 7)
    (sp1, ssrd, smd), n_all = sort_lanes(st, p1, rd,
                                         torch.ones_like(md, dtype=torch.bool),
                                         md)
    for rule in (True, False):
        a = cst.any_blocker_stream(st, sp1, ssrd, smd, rule, n_all)
        b = ci.any_blocker(pk, sp1, ssrd, smd, rule)
        c = cst.any_blocker_stream_plain(st, sp1[sub], ssrd[sub], smd[sub],
                                         rule)
        torch.cuda.synchronize()
        blk_err = max(blk_err, blocker_verdicts(
            f"random segments dielectrics_block={rule}", a, b, a[sub], c))
    res["nearest_hit_stream"]["max_abs_err"] = hit_err
    res["nearest_hit_stream_counts"]["max_abs_err"] = hit_err
    res["any_blocker_stream"]["max_abs_err"] = blk_err
    res["any_blocker_stream_counts"]["max_abs_err"] = blk_err
    per_bounce(st, lanes, res)

    # ---- 12. the probe through its entry point, then against its plain
    # version and tab[:, idx] ----
    g = torch.Generator(device="cuda").manual_seed(12)
    ins = [(torch.rand((12, d), device="cuda", generator=g),
            torch.randint(0, d, (PROBE_ROWS, 128), device="cuda", generator=g,
                          dtype=torch.int32)) for d in PROBE_D]
    _kernels.reset_counts()
    outs = [probes.onehot_fetch(tab, idx) for tab, idx in ins]
    counts["probe"] = dict(_kernels.launches)
    check(counts["probe"]["onehot_fetch"] == len(PROBE_D),
          f"probe launches {counts['probe']}")
    for (tab, idx), out in zip(ins, outs):
        il = idx.long()
        lib = tab[:, il].permute(1, 0, 2).reshape(PROBE_ROWS * 12, 128)
        plain = probes.onehot_fetch_plain(tab, idx)
        check(torch.equal(out, plain) and torch.equal(out, lib),
              f"onehot_fetch D {tab.shape[1]}: differs from plain or "
              "tab[:, idx]")
        r = dict(name="onehot_fetch", max_abs_err=(out - plain).abs().max()
                 .item(),
                 ms=graph_ms(lambda: probes.onehot_fetch(tab, idx)),
                 host_ms=time_ms(lambda: probes.onehot_fetch(tab, idx), 20),
                 plain_ms=time_ms(lambda: probes.onehot_fetch_plain(tab, idx),
                                  3),
                 **bound(12 * tab.shape[1] * 4 + PROBE_ROWS * 128 * 4
                         + PROBE_ROWS * 12 * 128 * 4, 0))
        r["library_ms"] = graph_ms(lambda: tab[:, il])
        r["library_host_ms"] = time_ms(lambda: tab[:, il], 20)
        print(f"[mesh] onehot_fetch rows {PROBE_ROWS} D {tab.shape[1]}: equal "
              f"to plain and tab[:, idx] bit for bit; device-only (graph "
              f"replay) {r['ms']:.5f} ms kernel, {r['library_ms']:.5f} ms "
              f"tab[:, idx]; a call with the host {r['host_ms']:.4f} ms "
              f"kernel, {r['library_host_ms']:.4f} ms tab[:, idx]; "
              f"{r['plain_ms']:.3f} ms plain; bound {r['bound_ms']:.5f} ms")
    res["onehot_fetch"] = r
    for r in res.values():
        print(f"[mesh] {r['name']}: {r['ms']:.3f} ms kernel, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    return list(res.values()), obj, big


def nonzero_share(img, what: str) -> None:
    import numpy as np

    share = float((np.asarray(img).sum(axis=1) > 0).mean())
    print(f"[big] {what}: {share:.4f} of pixels non-zero")
    check(share > 0.01, f"{what}: only {share} of pixels are non-zero")


def enclosed_scene(mesh, textured: bool):
    """``scenes/cornell.txt``'s room, blocks, spheres and lights, parsed by
    the port's parser, with ``mesh``'s icosphere scaled to radius
    ``ENCLOSED_R`` and standing on the floor at ``ENCLOSED_C`` (white
    diffuse; ``textured``: with its UVs and checker texture, the room's
    triangles untextured).  Float32 positions, so that a text scene
    written with 9 significant digits parses back to the same scene."""
    import numpy as np

    from path_tracing_tpu_torch.scene.parser import load_scene

    p = load_scene(str(SCENE))
    n_room = len(p.tri_verts)
    tv = np.asarray(mesh.tri_verts, np.float32)
    tv = tv * np.float32(ENCLOSED_R) + np.asarray(ENCLOSED_C, np.float32)
    p.tri_verts += tv.tolist()
    p.tri_mtl += mesh.tri_mtl
    p.tri_group += [0] * len(tv)
    if textured:
        p.tri_uv = [[0.0] * 6] * n_room + list(mesh.tri_uv)
        p.tri_tex = [-1] * n_room + list(mesh.tri_tex)
        p.textures = list(mesh.textures)
    return p


def write_scene_txt(parsed, path) -> str:
    """``parsed`` (an untextured ``enclosed_scene``) as a text scene for
    the CLI: cornell's records, then the mesh's triangles."""
    import numpy as np

    tv = np.asarray(parsed.tri_verts[ROOM_TRIS:], np.float32).reshape(-1, 9)
    with open(path, "w") as f:
        f.write(SCENE.read_text())
        f.write("\nM " + " ".join(f"{x:.9g}" for x in parsed.tri_mtl[-1])
                + "\n")
        np.savetxt(f, tv, fmt="T" + " %.9g" * 9)
    return str(path)


def walk_counts(scene, parsed, label: str) -> None:
    """#5's counting build at 128x72 spp 4 on ``scene``: the walks' tests
    a bounce and a shadow ray (where a big mesh's time goes)."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.ops import cuda_wavefront as cw
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.scene.camera import make_camera

    cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up, parsed.fov,
                      SMALL_W, SMALL_H, device="cuda")
    idx = torch.arange(SMALL_W * SMALL_H, dtype=torch.int32, device="cuda")
    pk = scene.packed
    _, c = cw.render_wavefront_counts(
        pk, scene.packed.light, cam, idx % SMALL_W, idx // SMALL_W, SPP,
        RenderConfig(width=SMALL_W, height=SMALL_H, spp=SPP, eye_depth=4),
        rng.fold_in(rng.prng_key(0), 0))
    it, sh = max(c["iterations"], 1), max(c["shadow_rays"], 1)
    print(f"[tier] {label} #5 counts at {SMALL_W}x{SMALL_H} spp {SPP} "
          f"({pk.n_super} supers): {c['iterations']} bounces, "
          f"{c['hit_boxes'] / it:.1f} boxes and {c['hit_tris'] / it:.1f} "
          f"triangles a bounce; {c['shadow_rays']} shadow rays, "
          f"{c['shadow_boxes'] / sh:.1f} boxes and {c['shadow_tris'] / sh:.1f}"
          " triangles each")


def phase_tier_decision(counts: dict, mesh, obj: str) -> tuple:
    """PT's ``auto`` above the resident ceiling.  On the convex icosphere
    and on the enclosed scene (the icosphere in cornell's room), untextured
    and textured, at 1920x1080 spp 4 from one key: the stream tier against
    the resident tier (mega untextured, fused textured) in turns (stream,
    resident, resident, stream).  The rule: auto takes the resident tier
    where it was faster in every turn and stream where stream was;
    ``resolve_tier`` must not pick a tier that was slower in every turn.
    #5's walk counts on the untextured scenes.  Images: >= 99.9% of pixels
    equal on the untextured convex mesh, >= 99% elsewhere.  Then through
    the CLI: auto on the textured OBJ and on the untextured enclosed scene
    (written as a text scene), and
    ``--tier stream`` on the textured OBJ (#6/#7's path).  Returns the
    enclosed scene (parsed and on the card) and its text scene's path."""
    import dataclasses

    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators.pt import render_pt, resolve_tier
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.scene.camera import make_camera

    cfg = RenderConfig(width=W, height=H, spp=SPP, eye_depth=4)
    key = rng.fold_in(rng.prng_key(0), 0)
    bare = dataclasses.replace(mesh, tri_uv=[], tri_tex=[], textures=[])
    cases = (("convex", bare, False),
             ("enclosed", enclosed_scene(mesh, False), False),
             ("convex", mesh, True),
             ("enclosed", enclosed_scene(mesh, True), True))
    imgs = {}
    for what, parsed, tex in cases:
        t0 = time.perf_counter()
        scene = parsed.to_device("cuda")
        setup = time.perf_counter() - t0
        cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up,
                          parsed.fov, W, H, device="cuda")
        res = "fused" if tex else "mega"
        label = f"{what} {scene.num_triangles}" + (" textured" if tex
                                                      else "")
        small = make_camera(parsed.eye, parsed.look_at, parsed.view_up,
                            parsed.fov, SMALL_W, SMALL_H, device="cuda")
        for tier in ("stream", res):        # warm-up: first calls, packing
            render_pt(scene, small, SMALL_W, SMALL_H, 1, cfg, key, tier=tier)
        ms = {"stream": [], res: []}
        for tier in ("stream", res, res, "stream"):         # in turns
            img, t = once_ms(lambda: render_pt(scene, cam, W, H, SPP, cfg,
                                               key, tier=tier))
            imgs[(what, tex, tier)] = img.cpu().numpy()
            ms[tier].append(t)
        for tier, t in ms.items():
            print(f"[tier] {label} {tier} in turns: "
                  f"{', '.join(f'{x:.1f}' for x in t)} ms, "
                  f"{', '.join(f'{B * SPP / x / 1e3:.3f}' for x in t)} "
                  f"Mpaths/s (scene to the card {setup:.1f} s)")
            nonzero_share(imgs[(what, tex, tier)], f"{label} {tier}")
        # the enclosed scene's delta chains (cornell's mirror wall, glass
        # and diamond) carry #6's last-ulp differences from #1 into whole
        # paths, as the textured bounce's fetch does: the 99% bar there
        compare(imgs[(what, tex, res)], imgs[(what, tex, "stream")],
                f"{label} stream vs {res}",
                0.999 if what == "convex" and not tex else 0.99)
        if max(ms[res]) < min(ms["stream"]):
            won = res
        elif max(ms["stream"]) < min(ms[res]):
            won = "stream"
        else:
            won = "neither"
        auto = resolve_tier(scene, "auto")
        print(f"[tier] {label}: {won} faster in every turn; auto picks "
              f"{auto}")
        check(won in (auto, "neither"), f"{label}: auto picks {auto}, "
              f"{won} was faster in every turn")
        if not tex:
            walk_counts(scene, parsed, label)
        if what == "enclosed" and not tex:
            enclosed = (parsed, scene)
        del scene

    # ---- through the CLI: auto and --tier stream ----
    res = counted("big_tex", obj, W, H, "auto", "big_1080p_auto", counts)
    c = counts["big_tex"]
    check(res["tier"] == "fused" and c["nearest_hit_stream"] == 0
          and c["render_wavefront"] == 0, f"auto on the textured "
          f"{BIG_TRIS}-triangle OBJ: {res['tier']} tier, launches {c}")
    stream = counted("stream", obj, W, H, "stream", "big_1080p_stream",
                     counts)
    c = counts["stream"]
    check(c["nearest_hit"] == c["shade_step_tex"] == c["render_wavefront"]
          == 0, f"stream path launches {c}")
    compare(res["image"], stream["image"], f"{BIG_TRIS} textured OBJ auto vs "
            "stream through the CLI", 0.99)
    t0 = time.perf_counter()
    txt = write_scene_txt(enclosed[0], OUT / f"enclosed_{ENCLOSED_TRIS}.txt")
    print(f"[tier] enclosed text scene written in "
          f"{time.perf_counter() - t0:.1f} s")
    res = counted("big_mega", txt, W, H, "auto", "enclosed_1080p_auto",
                  counts)
    check(res["tier"] == "mega", f"auto picked {res['tier']} on the "
          "enclosed scene")
    compare(imgs[("enclosed", False, "mega")], res["image"],
            "enclosed mega in process vs auto through the CLI", 0.999)
    return enclosed, txt


def phase_big_ppm(counts: dict, enclosed, txt: str) -> tuple:
    """PPM on the enclosed scene: ``ppm_eye`` on the first 512x512 pass
    held bit for bit against the eye loop on #1 (``ppm_eye_plain``), whose
    #1 launches (recorded) are held against the plain
    nearest hit on their live lanes (at most ``EYE_HOLD_LANES`` a launch:
    the plain version is a brute force over 327,716 triangles), #10 (its
    ``kWalkSuper`` instance) against ``photon_trace_plain`` on the pass's
    first 4,096 photons, then the CLI's auto at 512x512, 3 passes of
    4 x 262,144 photons.  Returns #1's times on the eye pass's launches
    and #10's on the pass, with the CLI's ms a pass."""
    from path_tracing_tpu_torch.kernel_times import record_launches
    from path_tracing_tpu_torch.ops import cuda_photon as cp
    from path_tracing_tpu_torch.ops import cuda_ppm_eye as ce
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.scene.camera import make_camera

    parsed, scene = enclosed
    cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up, parsed.fov,
                      PPM_W, PPM_H, device="cuda")
    cfg, direct, hp, emit, kp = ppm_frame(scene, cam)
    pk = scene.packed
    check(pk.n_super > 0, "the enclosed scene is not on the super walk")
    idx = torch.arange(PPM_W * PPM_H, dtype=torch.int32, device="cuda")
    loop, rec = record_launches(lambda: ce.ppm_eye_plain(
        pk, cam, cfg, idx % PPM_W, idx // PPM_W,
        rng.fold_in(rng.fold_in(rng.prng_key(0), 0), 1)))
    check(same_eye_pass((direct, hp), loop),
          "ppm_eye differs from the eye loop on #1 on the enclosed scene")
    eye = hold_launches("nearest_hit", rec["nearest_hit"],
                        "enclosed PPM eye pass", max_live=EYE_HOLD_LANES)
    P = emit[0].shape[0]
    n = PHOTON_SUBSET
    targs = (pk, *(x[:n] for x in emit), kp, cfg.light_depth,
             cfg.max_light_iters, 0, P)
    ev, valid = cp.photon_trace(*targs)
    (ev_p, valid_p), plain_ms = once_ms(lambda: cp.photon_trace_plain(*targs))
    same = (valid == valid_p).float().mean().item()
    both = valid & valid_p
    close = torch.isclose(ev[both], ev_p[both], rtol=1e-5, atol=1e-6).all(
        dim=1).float().mean().item()
    equal = (ev[both] == ev_p[both]).all(dim=1).float().mean().item()
    check(same >= 0.9999 and close >= 0.9999 and int(valid.sum()) > 0,
          f"photon_trace on the enclosed scene: valid flags agree on "
          f"{same:.6f} of rows, fields on {close:.6f} of the valid ones")
    full = (pk, *emit, kp, cfg.light_depth, cfg.max_light_iters)
    ms = time_ms(lambda: cp.photon_trace(*full), 3)
    print(f"[bigppm] photon_trace (the super walk, {pk.n_super} supers) on "
          f"photons [0, {n}) of the {P}-photon pass: valid flags equal on "
          f"{same:.6f} of rows, {int(valid.sum())} valid; fields within rtol "
          f"1e-5 / atol 1e-6 on {close:.6f}, bit-equal {equal:.6f}; plain "
          f"{plain_ms:.1f} ms; the whole pass {ms:.3f} ms kernel")
    extra = ["--spl", str(PPM_SPL), "--light-depth", "4", "--iters",
             str(BIG_PPM_PASSES)]
    res = counted("big_ppm", txt, PPM_W, PPM_H, "auto", "enclosed_ppm_512",
                  counts, "ppm", extra)
    c = counts["big_ppm"]
    check(res["tier"] == "mega" and c["photon_trace"] == c["gather_flux"]
          == c["ppm_eye"] == BIG_PPM_PASSES,
          f"PPM on the enclosed scene: {res['tier']} tier, launches {c}")
    nonzero_share(res["image"], "enclosed PPM")
    return dict(per_launch=eye, ms=sum(r["ms"] for r in eye)), dict(
        ms=ms, plain_ms=plain_ms, plain_photons=n, pass_ms=res["seconds"]
        * 1e3 / BIG_PPM_PASSES)


def phase_big_bdpt(counts: dict, enclosed, txt: str) -> dict:
    """BDPT on the enclosed scene: #9 against ``bdpt_eye_plain`` at
    ``BIG_BDPT_W`` x ``BIG_BDPT_H`` spp 1 on its tile-RIS K = 32 tables,
    ``bdpt_light``'s super-walk instance on the 1080p frame's light trace
    (``hold_light``), then the CLI's auto (mega) at 1920x1080 spp 4,
    tile-RIS K = 32.  Returns the light trace's row."""
    from path_tracing_tpu_torch.ops import cuda_bdpt_eye as ce

    parsed, scene = enclosed
    args = small_bdpt(parsed, RIS_K, BIG_BDPT_W, BIG_BDPT_H, 1, scene)
    check(args[0].n_super > 0, "the enclosed scene is not on the super walk")
    light, _ = hold_light(scene, "bdpt_light_super", "the enclosed scene")
    a, ms = once_ms(lambda: ce.bdpt_eye(*args))
    b, plain_ms = once_ms(lambda: ce.bdpt_eye_plain(*args))
    hold_eye(f"enclosed tile-RIS K={RIS_K} {BIG_BDPT_W}x{BIG_BDPT_H} spp 1",
             a, b, loose_ok=True)
    print(f"[bigbdpt] bdpt_eye {BIG_BDPT_W}x{BIG_BDPT_H}: {ms:.1f} ms "
          f"kernel, {plain_ms:.1f} ms plain")
    res = counted("big_bdpt", txt, W, H, "auto", "enclosed_bdpt_1080p",
                  counts, "bdpt", ["--spl", str(SPL), "--light-depth", "4",
                                   "--resample", str(RIS_K)])
    c = counts["big_bdpt"]
    check(res["tier"] == "mega" and c["bdpt_eye"] == 1 and c["connect"] == 0,
          f"BDPT on the enclosed scene: {res['tier']} tier, launches {c}")
    nonzero_share(res["image"], "enclosed BDPT")
    return light


def phase_checkpoint() -> None:
    """Checkpoint resume through the CLI on the PT main path (cornell,
    1920x1080 spp 4): two iterations, then a resume for one more, bit-equal
    to three uninterrupted iterations; and one ``--profile`` run whose
    Chrome trace must exist and hold events."""
    import numpy as np

    from path_tracing_tpu_torch.film import load_checkpoint
    from path_tracing_tpu_torch.profiling import TRACE_FILE

    ck = OUT / "resume.npz"
    ck.unlink(missing_ok=True)
    full = run_cli(SCENE, W, H, "auto", "ckpt_full", extra=["--iters", "3"])
    first = run_cli(SCENE, W, H, "auto", "ckpt_first",
                    extra=["--iters", "2", "--checkpoint", str(ck)])
    resumed = run_cli(SCENE, W, H, "auto", "ckpt_resumed",
                      extra=["--iters", "1", "--checkpoint", str(ck)])
    state, meta = load_checkpoint(str(ck))
    check(first["iters"] == 2 and resumed["iters"] == 1
          and state.n_iters == 3, f"checkpoint: {first['iters']} + "
          f"{resumed['iters']} iterations, {state.n_iters} saved")
    check(np.array_equal(full["image"], resumed["image"]),
          "checkpoint: the resumed render differs from the uninterrupted one")
    print(f"[ckpt] cornell {W}x{H} spp {SPP}: 2 iterations + a resume for 1 "
          "bit-equal to 3 uninterrupted (mode "
          f"{meta['mode']}, {state.n_iters} iterations in the checkpoint)")
    prof = OUT / "profile"
    run_cli(SCENE, SMALL_W, SMALL_H, "auto", "profiled",
            extra=["--profile", str(prof)])
    trace = prof / TRACE_FILE
    events = json.loads(trace.read_text()).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(trace.stat().st_size > 0 and events, f"--profile: {trace} is "
          "empty")
    print(f"[ckpt] --profile wrote {trace} ({trace.stat().st_size} bytes, "
          f"{len(events)} events, {len(kernels)} kernel events: "
          f"{sorted({e['name'][:40] for e in kernels})})")


LEGACY_KS = (0.9, 0.6, 0.3)   # the Ks record on cornell's glass sphere
GLASS = "M 1 1 1 0.0 0.0 1.5     // glass\n"
LEGACY_PPM_PASSES = 3
CONN_SAMPLES = 16             # M of the sampled-connection frame
TEX_PPM_SPL = 1048576         # the textured OBJ's one light: 1,048,576 a pass


def legacy_cornell(path) -> str:
    """``scenes/cornell.txt`` with a K record on its glass sphere's
    material (Ks ``LEGACY_KS``, refract 1.5), written to ``path``: under
    the GPU rule that sphere multiplies its Ks into a shadow ray and every
    other occluder blocks."""
    txt = SCENE.read_text()
    check(GLASS in txt, "cornell.txt has no glass material line")
    Path(path).write_text(txt.replace(
        GLASS, GLASS + "K %g %g %g 1.5\n" % LEGACY_KS))
    return str(path)


def _clone(x):
    """``x`` with every tensor in it (tuples, lists, dicts, Materials)
    cloned."""
    import dataclasses

    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _clone(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def record_calls(module, attr: str, call) -> tuple:
    """``call()``'s result and the arguments of every call of
    ``module.attr`` that it makes, cloned: [(args, kwargs), ...]."""
    own, got = getattr(module, attr), []

    def rec(*args, **kw):
        got.append((_clone(args), _clone(kw)))
        return own(*args, **kw)

    setattr(module, attr, rec)
    try:
        res = call()
    finally:
        setattr(module, attr, own)
    return res, got


def hold_rgb(calls: list, what: str) -> dict:
    """``transmittance_rgb`` on each recorded launch (the split frame's NEE
    shadow rays with their live lanes) against its plain version: rtol
    1e-6 / atol 1e-7 on every live lane, exactly 1 on the others; timed
    (CUDA events) on each launch; the bound of the first from the plain
    walk model's counts.  Returns its result row."""
    from path_tracing_tpu_torch.ops import cuda_connect as cc
    from path_tracing_tpu_torch.ops import cuda_intersect as ci

    per, err, live_n, tinted = [], 0.0, 0, None
    for i, (args, kw) in enumerate(calls):
        live = kw["live"]
        a = ci.transmittance_rgb(*args, **kw)
        b = ci.transmittance_rgb_plain(*args, **kw)
        if tinted is None:
            tinted = ((b > 0) & (b < 1)).any(dim=1)[live].float().mean()
        ok = torch.isclose(a, b, rtol=1e-6, atol=1e-7).all(dim=1)
        check(bool(ok[live].all()) and bool((a[~live] == 1.0).all()),
              f"transmittance_rgb {what}: launch {i} differs from its plain "
              f"version on {int((~ok[live]).sum())} live lanes")
        err = max(err, (a - b).abs().max().item())
        live_n += int(live.sum())
        per.append(dict(ms=time_ms(lambda: ci.transmittance_rgb(*args, **kw),
                                   3), live=int(live.sum())))
    args, kw = calls[0]
    pc = cc.new_counts()
    _, plain_ms = once_ms(lambda: ci.transmittance_rgb_plain(*args, **kw,
                                                             counts=pc))
    Bl, n = args[1].shape[0], int(kw["live"].sum())
    bnd = bound(n * 28 + Bl + Bl * 12, walk_ops(pc))
    print(f"[legacy] transmittance_rgb on each of the {what}'s {len(per)} "
          f"launches, every live lane within rtol 1e-6 / atol 1e-7 of the "
          f"plain version ({live_n} live lanes; max abs err {err:.3g}; the "
          f"first launch's live lanes {tinted.item():.4f} tinted by the "
          f"glass sphere); ms / live lanes: "
          + ", ".join(f"{r['ms']:.4f} / {r['live']}" for r in per)
          + f"; {sum(r['ms'] for r in per):.3f} ms in all; the first launch "
          f"{per[0]['ms']:.4f} ms, plain {plain_ms:.1f} ms, counted bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; the walk's "
          f"{ {k: pc[k] for k in WALK_KEYS['any_blocker']} })")
    return dict(name="transmittance_rgb", max_abs_err=err, ms=per[0]["ms"],
                plain_ms=plain_ms, per_launch=per,
                split_ms=sum(r["ms"] for r in per), **bnd)


def hold_connect(name: str, calls: list, what: str) -> dict:
    """#8's instance ``name`` on each recorded launch (``cuda_connect``'s
    ``_launch`` arguments) against ``connect_plain`` on the same inputs:
    max-channel relative error < 1e-3 on every active lane, every inactive
    lane 0 (phase 6's bar); timed (CUDA events) on each launch; the bound
    of the first from the plain counts.  Returns its result row."""
    from path_tracing_tpu_torch.ops import cuda_connect as cc

    per, err, worst = [], 0.0, 0.0
    for i, (args, _) in enumerate(calls):
        nm, cargs, clamp_val, blocks, vidx = args
        check(nm == name, f"{what}: launch {i} is {nm}, not {name}")
        kw = dict(clamp_val=clamp_val, dielectrics_block=blocks, vidx=vidx)
        act = cargs[-1]
        a = cc.connect(*cargs, **kw)
        b = cc.connect_plain(*cargs, **kw)
        rel = ((a - b).abs() / (b.abs() + 1e-3)).max(dim=1).values[act]
        check(bool((rel < 1e-3).all()) and bool((a[~act] == 0).all()),
              f"{name} {what}: launch {i} max relative error "
              f"{rel.max().item() if rel.numel() else 0}")
        err = max(err, (a - b).abs().max().item())
        worst = max(worst, rel.max().item() if rel.numel() else 0.0)
        per.append(dict(ms=time_ms(lambda: cc.connect(*cargs, **kw), 1),
                        active=int(act.sum())))
    (nm, cargs, clamp_val, blocks, vidx), _ = calls[0]
    kw = dict(clamp_val=clamp_val, dielectrics_block=blocks, vidx=vidx)
    pc = cc.new_counts()
    _, plain_ms = once_ms(lambda: cc.connect_plain(*cargs, **kw, counts=pc))
    Bl, n_valid = cargs[3].shape[0], cargs[2]
    nbytes = Bl * (23 * 4 + 12) + n_valid * 160
    if vidx is not None:
        nbytes += vidx.numel() * 4
    bnd = bound(nbytes, sweep_ops(pc))
    print(f"[{what}] {name} on each of the frame's {len(per)} launches, "
          f"every active lane within max-channel relative error "
          f"{worst:.3g} < 1e-3 of connect_plain (max abs err {err:.3g}); "
          f"ms / active lanes: "
          + ", ".join(f"{r['ms']:.3f} / {r['active']}" for r in per)
          + f"; {sum(r['ms'] for r in per):.1f} ms in all; the first launch "
          f"{per[0]['ms']:.3f} ms, plain {plain_ms:.1f} ms, counted bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; rows "
          f"{pc['rows']}, shadow rays {pc['shadow_rays']}, walk tests "
          f"{pc['shadow_spheres']} / {pc['shadow_boxes']} / "
          f"{pc['shadow_tris']})")
    return dict(name=name, max_abs_err=err, ms=per[0]["ms"],
                plain_ms=plain_ms, per_launch=per,
                split_ms=sum(r["ms"] for r in per), **bnd)


def phase_legacy(counts: dict) -> list:
    """Legacy-Ks cornell (``legacy_cornell``) through the CLI: PT at
    1920x1080 spp 4 (auto: the split tier, ``transmittance_rgb`` in place
    of #2), BDPT at 1080p spp 4, spl 8, global RIS K = 32 (auto: fused,
    #8's RGB instance), each kernel held on every launch of its frame; PPM
    at 512x512 for ``LEGACY_PPM_PASSES`` passes, bit-equal to cornell's
    without the record."""
    import numpy as np

    from path_tracing_tpu_torch.ops import cuda_connect as cc
    from path_tracing_tpu_torch.ops import cuda_shade as cs

    OUT.mkdir(parents=True, exist_ok=True)
    txt = legacy_cornell(OUT / "cornell_k.txt")
    res, calls = record_calls(cs, "transmittance_rgb", lambda: counted(
        "legacy_pt", txt, W, H, "auto", "legacy_pt_1080p", counts))
    c = counts["legacy_pt"]
    check(res["tier"] == "split" and c["any_blocker"] == 0
          and c["render_wavefront"] == c["shade_step"] == 0
          and len(calls) == c["transmittance_rgb"],
          f"legacy PT: {res['tier']} tier, launches {c}")
    nonzero_share(res["image"], "legacy PT")
    rows = [hold_rgb(calls, "legacy PT 1080p split frame")]
    del calls

    bdpt = ["--spl", str(SPL), "--light-depth", "4", "--resample",
            str(RIS_K)]
    res, calls = record_calls(cc, "_launch", lambda: counted(
        "legacy_bdpt", txt, W, H, "auto", "legacy_bdpt_1080p", counts,
        "bdpt", bdpt))
    c = counts["legacy_bdpt"]
    check(res["tier"] == "fused" and c["connect"] == 0
          and c["bdpt_eye"] == 0 and c["connect_rgb"] == len(calls),
          f"legacy BDPT: {res['tier']} tier, launches {c}")
    nonzero_share(res["image"], "legacy BDPT")
    rows.append(hold_connect("connect_rgb", calls, "legacy"))
    del calls

    ppm = ["--spl", str(PPM_SPL), "--light-depth", "4", "--iters",
           str(LEGACY_PPM_PASSES)]
    a = counted("legacy_ppm", txt, PPM_W, PPM_H, "auto", "legacy_ppm_512",
                counts, "ppm", ppm)
    b = run_cli(SCENE, PPM_W, PPM_H, "auto", "cornell_ppm_512_3", "ppm", ppm)
    check(np.array_equal(a["image"], b["image"]),
          "legacy PPM differs from cornell's without the K record")
    print(f"[legacy] PPM {PPM_W}x{PPM_H}, {LEGACY_PPM_PASSES} passes: "
          "bit-equal to cornell's without the K record")
    return rows


def phase_sampled(counts: dict) -> dict:
    """Sampled connections through the CLI: cornell at 1920x1080 spp 4,
    spl 8, the exact table, ``--conn-samples CONN_SAMPLES`` (auto: fused,
    #8's sampled instance), the kernel held on every launch of the frame;
    its image against the exact fused sweep's in mean (5%: an estimate of
    the same sum)."""
    from path_tracing_tpu_torch.ops import cuda_connect as cc

    bdpt = ["--spl", str(SPL), "--light-depth", "4", "--conn-samples",
            str(CONN_SAMPLES)]
    res, calls = record_calls(cc, "_launch", lambda: counted(
        "sampled", SCENE, W, H, "auto", "bdpt_1080p_sampled", counts, "bdpt",
        bdpt))
    c = counts["sampled"]
    check(res["tier"] == "fused" and c["connect"] == 0
          and c["connect_sampled"] == len(calls),
          f"sampled BDPT: {res['tier']} tier, launches {c}")
    nonzero_share(res["image"], "sampled BDPT")
    return hold_connect("connect_sampled", calls, "sampled")


def phase_tex_integrators(counts: dict) -> list:
    """BDPT and PPM on phase 5's 81,920-triangle textured OBJ through the
    CLI: BDPT at 1920x1080 spp 4, spl 8, global RIS K = 32 (auto: fused,
    #1 with_uv and #8), ``bdpt_light_tex`` (its super walk) first held
    against the light loop on the frame's light trace (``hold_light``),
    and on the 1,280-triangle textured icosphere in cornell's room; PPM at 512x512, 10 passes of 1,048,576 photons
    (#1 with_uv, #10's textured instance, #11), #10 first held against its
    plain version on the first 4,096 photons of the first pass (valid
    flags equal and fields within rtol 1e-5 / atol 1e-6 on >= 99.99% of
    rows) and timed on them and on the whole pass."""
    import dataclasses

    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators import ppm
    from path_tracing_tpu_torch.ops import cuda_photon as cp
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.scene import synth
    from path_tracing_tpu_torch.scene.obj_loader import load_any_scene

    obj = OUT / f"icosphere_{MESH_TRIS}.obj"
    if not obj.exists():
        synth.write_obj(synth.icosphere_scene(MESH_TRIS, textured=True),
                        str(obj))
    res = counted("tex_bdpt", obj, W, H, "auto", "tex_bdpt_1080p", counts,
                  "bdpt", ["--spl", str(SPL), "--light-depth", "4",
                           "--resample", str(RIS_K)])
    c = counts["tex_bdpt"]
    check(res["tier"] == "fused" and c["bdpt_eye"] == 0,
          f"textured BDPT: {res['tier']} tier, launches {c}")
    nonzero_share(res["image"], "textured BDPT")

    scene = load_any_scene(str(obj)).to_device("cuda")
    pk = scene.packed
    check(pk.textured and pk.n_super > 0, "the textured OBJ's tables")
    light, _ = hold_light(scene, "bdpt_light_tex", "the textured OBJ")
    cfg = RenderConfig(width=PPM_W, height=PPM_H, spl=TEX_PPM_SPL,
                       eye_depth=4, light_depth=4)
    kp = rng.fold_in(rng.fold_in(rng.prng_key(0), 0), 2)
    emit = ppm.photon_emission(scene, scene.num_lights * TEX_PPM_SPL,
                               TEX_PPM_SPL, kp)
    P, n = emit[0].shape[0], PHOTON_SUBSET
    sub = (pk, *(x[:n] for x in emit), kp, cfg.light_depth,
           cfg.max_light_iters, 0, P)
    ev, valid = cp.photon_trace(*sub)
    pc = cp.new_counts()
    (ev_p, valid_p), plain_ms = once_ms(lambda: cp.photon_trace_plain(
        *sub, counts=pc))
    same = (valid == valid_p).float().mean().item()
    both = valid & valid_p
    close = torch.isclose(ev[both], ev_p[both], rtol=1e-5, atol=1e-6).all(
        dim=1).float().mean().item()
    equal = (ev[both] == ev_p[both]).all(dim=1).float().mean().item()
    check(same >= 0.9999 and close >= 0.9999 and int(valid.sum()) > 0,
          f"photon_trace_tex: valid flags agree on {same:.6f} of rows, "
          f"fields on {close:.6f} of the valid ones")
    ms = time_ms(lambda: cp.photon_trace(*sub), 5)
    full = (pk, *emit, kp, cfg.light_depth, cfg.max_light_iters)
    pass_ms = time_ms(lambda: cp.photon_trace(*full), 3)
    bnd = bound(n * 40 + ev.numel() * 4 + valid.numel(), photon_ops(pc))
    # the whole pass's bound: its bytes, and the operations of its walks as
    # #10's untextured counting build counts them on the same photons (a
    # texel scales a photon's flux, never its path: the events' flags,
    # positions, normals and directions are held equal); the texel
    # fetches are not counted
    fev, fvalid = cp.photon_trace(*full)
    bare = dataclasses.replace(pk, atlas=pk.atlas[:0],
                               tex_size=pk.tex_size[:0])
    cev, cvalid, fc = cp.photon_trace_counts(bare, *full[1:])
    check(torch.equal(cvalid, fvalid)
          and torch.equal(cev[fvalid, :9], fev[fvalid, :9]),
          "photon_trace_counts on the textured pass: other photon paths")
    # (the counting build has no count of the per-iteration fold_ins: at
    # most cfg.max_light_iters of them, 1,440 operations, left out)
    whole = bound(P * 40 + fev.numel() * 4 + fvalid.numel(),
                  photon_ops(dict(fc, iteration_keys=0)))
    print(f"[textured] photon_trace_tex over the whole {P}-photon pass: "
          f"{pass_ms:.3f} ms, bound {whole['bound_ms']:.4f} ms "
          f"({whole['bound_by']}; {fc['bounces']} bounces, "
          f"{fc['hit_tris']} triangle tests), "
          f"{whole['bound_ms'] / pass_ms:.2%} of it; {card_label()}")
    print(f"[textured] photon_trace_tex on photons [0, {n}) of the "
          f"{P}-photon pass: valid flags equal on {same:.6f} of rows, "
          f"{int(valid.sum())} valid; fields within rtol 1e-5 / atol 1e-6 "
          f"on {close:.6f}, bit-equal {equal:.6f}; {ms:.3f} ms kernel, "
          f"plain {plain_ms:.1f} ms, counted bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']}); the whole pass {pass_ms:.3f} ms")
    err = (ev[both] - ev_p[both]).abs().max().item() if both.any() else 0.0
    # the convex sphere sends no photon back to itself: the texel in a
    # bounced photon's flux shows in cornell's room, on the walls
    room = enclosed_scene(synth.icosphere_scene(SMALL_MESH_TRIS,
                                                textured=True), True)
    rs = room.to_device("cuda")
    rpk = rs.packed
    # the sphere alone stores few light vertices: the room's walls send
    # light paths onto the texture
    hold_light(rs, "bdpt_light_tex",
               f"the {SMALL_MESH_TRIS}-triangle textured icosphere in "
               "cornell's room")
    remit = ppm.photon_emission(rs, PHOTON_SUBSET, PHOTON_SUBSET // 4, kp)
    rargs = (rpk, *remit, kp, cfg.light_depth, cfg.max_light_iters)
    ev, valid = cp.photon_trace(*rargs)
    ev_p, valid_p = cp.photon_trace_plain(*rargs)
    both = valid & valid_p
    close = torch.isclose(ev[both], ev_p[both], rtol=1e-5, atol=1e-6).all(
        dim=1).float().mean().item()
    later = int(valid[PHOTON_SUBSET:].sum())
    check(bool((valid == valid_p).float().mean() >= 0.9999)
          and close >= 0.9999 and later > 0,
          f"photon_trace_tex in the room: fields on {close:.6f} of the "
          f"valid rows, {later} deposits past the first")
    err = max(err, (ev[both] - ev_p[both]).abs().max().item())
    print(f"[textured] photon_trace_tex on {PHOTON_SUBSET} photons of "
          f"cornell's lights with the {SMALL_MESH_TRIS}-triangle textured "
          f"icosphere in its room: valid flags equal, {int(valid.sum())} "
          f"valid ({later} past the first deposit), fields within rtol "
          f"1e-5 / atol 1e-6 on {close:.6f}")
    row = dict(name="photon_trace_tex", max_abs_err=err, ms=ms,
               plain_ms=plain_ms, plain_lanes=n, pass_ms=pass_ms,
               pass_bound_ms=whole["bound_ms"],
               pass_bound_by=whole["bound_by"], **bnd)
    res = counted("tex_ppm", obj, PPM_W, PPM_H, "auto", "tex_ppm_512",
                  counts, "ppm", ["--spl", str(TEX_PPM_SPL), "--light-depth",
                                  "4", "--iters", str(PPM_PASSES)])
    c = counts["tex_ppm"]
    check(res["tier"] == "mega" and c["photon_trace_tex"] == PPM_PASSES
          and c["photon_trace"] == 0 and c["gather_flux"] == PPM_PASSES,
          f"textured PPM: {res['tier']} tier, launches {c}")
    nonzero_share(res["image"], "textured PPM")
    return [row, light]


SHARD_RANKS = 2           # phase 19: ranks on the one card (gloo)
PPM_HASH_PASSES = 3


def phase_hash_gather(counts: dict) -> None:
    """18. The hash-grid gather (``ppm.gather_flux_hash``, PyTorch) on the
    hitpoints of the first 512x512 PPM pass on cornell and #10's events of
    its 1,048,576 photons: at the defaults (K = 64), then with
    ``ppm_max_per_cell`` raised to the pass's longest neighbour-cell run
    (no overflow) against #11 on the same inputs (counts equal on >= 99.9%
    of valid hitpoints and fewer on none, the rest the hash's collision
    double counts; flux within rtol 1e-4 / atol 1e-6 where the counts are
    equal, at least #11's within that tolerance where the hash counts
    more); then ``--tier hash`` through the CLI, 3 passes."""
    from path_tracing_tpu_torch.integrators import ppm
    from path_tracing_tpu_torch.ops import cuda_photon as cp
    from path_tracing_tpu_torch.ops import cuda_ppm_gather as cg
    from path_tracing_tpu_torch.scene.camera import make_camera
    from path_tracing_tpu_torch.scene.parser import load_scene

    card = card_label()
    p = load_scene(str(SCENE))
    scene = p.to_device("cuda")
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, PPM_W, PPM_H,
                      device="cuda")
    cfg, _, hp, emit, kp = ppm_frame(scene, cam)
    events = ppm.PhotonEvents(*cp.photon_trace(
        scene.packed, *emit, kp, cfg.light_depth,
        cfg.max_light_iters))
    runs = ppm.hash_runs(scene, cfg, hp, events)[2]
    most = int(runs.max())
    ppm.gather_flux_hash(scene, cfg, hp, events)           # warm-up
    (_, count, overflow), ms = once_ms(
        lambda: ppm.gather_flux_hash(scene, cfg, hp, events))
    n_ev, n_hp = int(events.valid.sum()), int(hp.valid.sum())
    print(f"[hash] gather_flux_hash {PPM_W}x{PPM_H} ({n_hp} valid "
          f"hitpoints), {emit[0].shape[0]} photons ({n_ev} valid events): "
          f"K {cfg.ppm_max_per_cell}, kmax "
          f"{min(most, cfg.ppm_max_per_cell)}, overflow {int(overflow)}, "
          f"{ms:.3f} ms wall (one host read of kmax); {card}")
    full = cfg.with_(ppm_max_per_cell=most)
    (fh, ch, oh), ms_full = once_ms(
        lambda: ppm.gather_flux_hash(scene, full, hp, events))
    (fx, cx, ox), ms_x = once_ms(
        lambda: cg.gather_flux(scene, cfg, hp, events))
    check(int(oh) == 0 and int(ox) == 0,
          f"overflow: hash {int(oh)} at K {most}, #11 {int(ox)}")
    v = hp.valid
    same, more = (ch == cx) & v, (ch > cx) & v
    n_same, n_more = int(same.sum()), int(more.sum())
    share = n_same / max(n_hp, 1)
    fewer = int(((ch < cx) & v).sum())
    close = int(torch.isclose(fh[same], fx[same], rtol=1e-4,
                              atol=1e-6).all(dim=1).sum())
    # a double count adds events, whose flux is not negative: at least
    # #11's flux within the same tolerance
    no_less = int((fh[more] >= fx[more] - (1e-6 + 1e-4 * fx[more].abs()))
                  .all(dim=1).sum())
    print(f"[hash] at K {most} (no overflow): {ms_full:.3f} ms wall against "
          f"#11's {ms_x:.3f} (prepare and join); counts equal on "
          f"{share:.6f} of valid hitpoints, {n_more} hitpoints with more "
          f"(collision double counts), {fewer} with fewer; flux within rtol "
          f"1e-4 / atol 1e-6 on {close} of the {n_same} equal ones, at least "
          f"#11's on {no_less} of the {n_more} with more; {card}")
    check(share >= 0.999 and close == n_same and fewer == 0
          and no_less == n_more,
          f"hash vs #11: counts equal on {share}, {fewer} fewer, flux on "
          f"{close} of the {n_same} equal ones, at least #11's on {no_less} "
          f"of the {n_more} with more")
    extra = ["--spl", str(PPM_SPL), "--light-depth", "4", "--iters",
             str(PPM_HASH_PASSES)]
    res = counted("ppm_hash", SCENE, PPM_W, PPM_H, "hash", "ppm_512_hash",
                  counts, "ppm", extra)
    c = counts["ppm_hash"]
    check(res["tier"] == "hash" and c["gather_flux"] == 0
          and c["photon_trace"] == PPM_HASH_PASSES,
          f"--tier hash: {res['tier']} tier, launches {c}")
    print(f"[hash] --tier hash through the CLI: "
          f"{res['photons'] / res['seconds'] / 1e6:.3f} Mphotons/s; {card}")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shard_setup():
    """Phase 19's scene, cameras (1080p, 512x512), key and configs (PT /
    BDPT, global or tile-local RIS K = 32, PPM)."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.scene.camera import make_camera
    from path_tracing_tpu_torch.scene.parser import load_scene

    p = load_scene(str(SCENE))
    scene = p.to_device("cuda")
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H,
                      device="cuda")
    pcam = make_camera(p.eye, p.look_at, p.view_up, p.fov, PPM_W, PPM_H,
                       device="cuda")
    cfg = RenderConfig(width=W, height=H, spp=SPP, spl=SPL, eye_depth=4,
                       light_depth=4)
    pcfg = RenderConfig(width=PPM_W, height=PPM_H, spl=PPM_SPL, eye_depth=4,
                        light_depth=4)
    return (scene, cam, pcam, rng.fold_in(rng.prng_key(0), 0), cfg,
            cfg.with_(bdpt_resample_vertices=RIS_K), pcfg)


# phase 19's sharded renders and the kernels each must launch in each rank
SHARD_KERNELS = {"pt": ("render_wavefront",),
                 "bdpt_fused": ("connect",) + BDPT_LIGHT,
                 "bdpt_tile_ris": ("bdpt_eye",) + BDPT_LIGHT,
                 "ppm": ("ppm_eye", "photon_trace", "gather_flux")}


def shard_rank(rank: int, world: int, port: int, backend: str,
               out_dir: str) -> None:
    """One rank of phase 19, started by ``torch.multiprocessing.spawn``:
    each sharded render (only PT under NCCL) with the counts reset just
    before and read just after, its wall time; rank 0 keeps the images."""
    import torch.distributed as dist

    from path_tracing_tpu_torch.ops import _kernels
    from path_tracing_tpu_torch.parallel import shard

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = shard.make_mesh(world, backend=backend)
        scene, cam, pcam, key, cfg, ris, pcfg = shard_setup()
        runs = {"pt": lambda: shard.render_pt_sharded(
                    scene, cam, W, H, SPP, cfg, key, mesh),
                "bdpt_fused": lambda: shard.render_bdpt_sharded(
                    scene, cam, W, H, SPP, SPL, ris, key, mesh,
                    tier="fused"),
                "bdpt_tile_ris": lambda: shard.render_bdpt_sharded(
                    scene, cam, W, H, SPP, SPL, ris, key, mesh,
                    tier="mega"),
                "ppm": lambda: shard.render_ppm_sharded(
                    scene, pcam, PPM_W, PPM_H, PPM_SPL, pcfg, key, mesh)}
        if backend == "nccl":
            runs = {"pt": runs["pt"]}
        res = {}
        for name, fn in runs.items():
            fn()              # warm, as the single-process renders are
            dist.barrier()
            _kernels.reset_counts()
            img, ms = once_ms(fn)
            res[name] = dict(ms=ms, launches=dict(_kernels.launches),
                             plain=dict(_kernels.plain_calls),
                             image=img.cpu() if rank == 0 else None)
        torch.save(res, Path(out_dir) / f"{backend}{world}_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, backend: str) -> list:
    """Phase 19's ranks, each a process on the one card; their results."""
    import torch.multiprocessing as mp

    out = OUT / "shard"
    out.mkdir(parents=True, exist_ok=True)
    mp.spawn(shard_rank, args=(world, free_port(), backend, str(out)),
             nprocs=world, join=True)
    return [torch.load(out / f"{backend}{world}_rank{r}.pt")
            for r in range(world)]


def phase_sharded() -> None:
    """19. ``parallel/shard.py`` with two ranks on the one card (gloo:
    NCCL refuses two ranks on one device), the cornell frame of the
    single-process renders and the same key: PT auto (#5) at 1080p spp 4
    and BDPT fused, global RIS K = 32, spl 8 (#1, #8 in both ranks)
    bit-equal to one process; BDPT mega, tile-local RIS K = 32 (#9): each
    rank's half bit-equal to ``eye_pass`` over the same window in one
    process; PPM, one 512x512 pass of 1,048,576 photons (#1, #10, #11):
    >= 99.9% of pixels within rtol 1e-5 / atol 1e-6 and the total energy
    within 1e-5; then PT on a one-rank NCCL mesh, bit-equal.  Each rank's
    kernels are counted over each render.  Wall times beside one
    process's (two ranks share one card: no scaling is claimed)."""
    import numpy as np

    from path_tracing_tpu_torch.integrators import bdpt, ppm
    from path_tracing_tpu_torch.integrators.pt import render_pt

    card = card_label()
    scene, cam, pcam, key, cfg, ris, pcfg = shard_setup()
    single = {"pt": lambda: render_pt(scene, cam, W, H, SPP, cfg, key),
              "bdpt_fused": lambda: bdpt.render_bdpt(
                  scene, cam, W, H, SPP, SPL, ris, key, tier="fused"),
              "bdpt_tile_ris": lambda: bdpt.render_bdpt(
                  scene, cam, W, H, SPP, SPL, ris, key),
              "ppm": lambda: ppm.render_ppm(scene, pcam, PPM_W, PPM_H,
                                            PPM_SPL, pcfg, key)}
    ref, ref_ms = {}, {}
    for name, fn in single.items():
        fn()                                   # warm, as the ranks are
        img, ref_ms[name] = once_ms(fn)
        ref[name] = img.cpu()
    # tile-local RIS folds a rank's first lane into its key: its windows
    used, lv, scale = bdpt.light_side(scene, ris, SPL, key)
    half = B // SHARD_RANKS
    windows = []
    for me in range(SHARD_RANKS):
        idx = torch.arange(me * half, (me + 1) * half, dtype=torch.int32,
                           device="cuda")
        windows.append(bdpt.eye_pass(used, lv, cam, ris, idx % W, idx // W,
                                     SPP, key, scale, start=me * half,
                                     total=B, tier="mega").cpu())
    windows = torch.cat(windows)

    t0 = time.perf_counter()
    ranks = spawn_ranks(SHARD_RANKS, "gloo")
    nccl = spawn_ranks(1, "nccl")
    print(f"[shard] {SHARD_RANKS} gloo ranks and 1 NCCL rank spawned, "
          f"rendered and joined in {time.perf_counter() - t0:.1f} s")
    for world, backend, rs in ((SHARD_RANKS, "gloo", ranks),
                               (1, "nccl", nccl)):
        for name in rs[0]:
            for r, res in enumerate(rs):
                check(sum(res[name]["plain"].values()) == 0,
                      f"{backend} rank {r} {name}: plain versions ran")
                for k in SHARD_KERNELS[name]:
                    check(res[name]["launches"][k] > 0,
                          f"{backend} rank {r} {name}: {k} not launched")
            img = rs[0][name]["image"]
            if name == "ppm":
                a, b = ref[name].numpy(), img.numpy()
                close = np.isclose(a, b, rtol=1e-5, atol=1e-6).all(
                    axis=1).mean()
                energy = abs(float(b.sum()) / float(a.sum()) - 1.0)
                ok = close >= 0.999 and energy < 1e-5
                what = (f"{close:.6f} of pixels within rtol 1e-5 / atol "
                        f"1e-6, total energy {energy:.3g} relative apart")
            else:
                want = windows if name == "bdpt_tile_ris" else ref[name]
                ok = torch.equal(img, want)
                what = ("bit-equal to " + ("its windows" if name ==
                        "bdpt_tile_ris" else "one process")) if ok else \
                    f"{(img != want).any(dim=1).sum().item()} pixels differ"
            ms = ", ".join(f"{res[name]['ms']:.1f}" for res in rs)
            print(f"[shard] {backend} x{world} {name}: {what}; wall {ms} ms "
                  f"a rank, one process {ref_ms[name]:.1f} ms; launches "
                  f"(rank 0) {sum(rs[0][name]['launches'].values())}; "
                  f"{card}")
            check(ok, f"{backend} x{world} {name}: {what}")


def phase_native(obj: str, txt: str) -> None:
    """20. The native runtime (``runtime/native.py``, built from
    ``csrc/pt_runtime.cc`` at first use): it must be available; the
    327,680-triangle textured OBJ parsed by it and by the Python parser
    (every table equal); the enclosed scene's text file parsed by it; #5's
    counting build at 128x72 and the mega frame at 1080p spp 4 (in turns)
    on the enclosed mesh under the numpy and the native cluster layouts."""
    import dataclasses

    import numpy as np

    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators.pt import render_pt
    from path_tracing_tpu_torch.ops import bvh, rng
    from path_tracing_tpu_torch.runtime import native
    from path_tracing_tpu_torch.scene.camera import make_camera
    from path_tracing_tpu_torch.scene.obj_loader import load_obj

    card = card_label()
    check(native.native_available(),
          f"the native runtime is not available: {native.build_info}")
    info = native.build_info
    print(f"[native] libpt_runtime {'built' if info['built'] else 'reused'}"
          f" and loaded in {info['seconds']:.2f} s; {card}")
    a, ms_native = once_ms(lambda: native.parse_scene_native(obj))
    b, ms_py = once_ms(lambda: load_obj(obj))
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "textures":
            check(len(x) == len(y) and all(np.array_equal(p, q)
                                           for p, q in zip(x, y)),
                  "native and Python parses: the textures differ")
        elif f.name.endswith("_legacy") and min(len(x), len(y)) == 0:
            check(not np.asarray(x).any() and not np.asarray(y).any(),
                  f"native and Python parses: {f.name} differ")
        else:
            check(np.array_equal(np.asarray(x, np.float32),
                                 np.asarray(y, np.float32)),
                  f"native and Python parses: {f.name} differ")
    print(f"[native] {BIG_TRIS}-triangle textured OBJ: native parse "
          f"{ms_native:.1f} ms, Python parse {ms_py:.1f} ms, every table "
          f"equal; {card}")
    enc, ms_txt = once_ms(lambda: native.parse_scene_native(txt))
    check(len(enc.tri_verts) == ENCLOSED_TRIS, "the enclosed text scene")
    print(f"[native] the enclosed {ENCLOSED_TRIS}-triangle text scene: "
          f"native parse {ms_txt:.1f} ms")
    layouts = {}
    for label, builder in (("numpy", bvh.build_clusters_py),
                           ("native", bvh.build_clusters)):
        saved, bvh.build_clusters = bvh.build_clusters, builder
        try:
            layouts[label] = enc.to_device("cuda")
        finally:
            bvh.build_clusters = saved
        walk_counts(layouts[label], enc, f"enclosed, {label} layout:")
    cam = make_camera(enc.eye, enc.look_at, enc.view_up, enc.fov, W, H,
                      device="cuda")
    cfg = RenderConfig(width=W, height=H, spp=SPP, eye_depth=4)
    key = rng.fold_in(rng.prng_key(0), 0)
    ms = {"numpy": [], "native": []}
    for label in ("numpy", "native", "native", "numpy"):       # in turns
        _, t = once_ms(lambda: render_pt(layouts[label], cam, W, H, SPP, cfg,
                                         key, tier="mega"))
        ms[label].append(t)
    for label, t in ms.items():
        print(f"[native] enclosed mega 1080p spp {SPP}, {label} layout, in "
              f"turns: {', '.join(f'{x:.1f}' for x in t)} ms; {card}")


def flake_walks(name: str, fast, counting, plain, args: tuple,
                live: torch.Tensor, timed=None) -> tuple:
    """#1's or #2's counting build on the sphereflake against the walk
    model's counts of the same ``live`` lanes (exactly), its output the
    kernel's; then the kernel timed on the ``timed`` lanes (every lane
    without) with its launches counted.  Returns (the plain counts, ms,
    launches)."""
    from path_tracing_tpu_torch.ops import _kernels, cuda_connect

    k, kc = counting(*args, live=live)
    out = fast(*args, live=live)
    check(torch.equal(k, out) if name == "any_blocker" else same_bits(k, out),
          f"{name}_counts on the flake: its output differs from {name}'s")
    pc = cuda_connect.new_counts()
    plain(*args, live=live, counts=pc)
    kind = "hit" if name == "nearest_hit" else "shadow"
    hold_counts(f"{name} sphereflake ({int(live.sum())} lanes)", kc, pc,
                tuple(f"{kind}_{t}" for t in ("spheres", "boxes", "tris")),
                exact=True)
    _kernels.reset_counts()
    ms = time_ms(lambda: fast(*args, live=timed), 10)
    launches = {k: v for k, v in _kernels.launches.items() if v}
    check(launches == {name: 11} and sum(_kernels.plain_calls.values()) == 0,
          f"{name} on the flake: launches {launches}, plain calls "
          f"{_kernels.plain_calls}")
    return pc, ms, launches


def phase_flake(counts: dict) -> dict:
    """21. The sphere index on SPD's sphereflake (see the module's
    docstring): #1, #2 and #5 on their indexed instances, each against
    its plain version, its counting build against the plain counts, its
    time, launches and bound.  Returns each kernel's ``flake`` entry."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.ops import cuda_intersect as ci
    from path_tracing_tpu_torch.ops import cuda_wavefront as cw
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.ops.intersect import INF, shadow_ray
    from path_tracing_tpu_torch.scene import synth
    from path_tracing_tpu_torch.scene.camera import make_camera

    p = synth.sphereflake_scene(FLAKE_LEVELS)
    scene = p.to_device("cuda")
    pk = scene.packed
    lt = pk.light
    check(pk.ns == 7381 and pk.nl == 3 and pk.nsc > 0 and pk.n_ssuper > 0,
          f"sphereflake: {pk.ns} spheres, {pk.nl} lights, {pk.nsc} "
          f"clusters, {pk.n_ssuper} supers")
    linear = pk.ns + pk.nl
    print(f"[flake] {pk.ns} spheres in {int((pk.scl[:pk.nsc, 7] > 0).sum())}"
          f" clusters under {pk.n_ssuper} supers, {pk.nt} triangles, "
          f"{pk.nl} light balls")
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H,
                      device="cuda")
    key = rng.prng_key(21)
    u = rng.uniform_rows(rng.iter_key(key, 0), B, 8, device="cuda")
    ro, rd = camera_rays(cam, u)
    live = thin(torch.ones(B, dtype=torch.bool, device="cuda"),
                FLAKE_COUNT_LANES)
    out = {}

    # #1 on the camera rays: t of every ray the brute force's bit for bit
    a = ci.nearest_hit(pk, ro, rd)
    b = ci.nearest_hit_plain(pk, ro, rd)
    t_equal = torch.equal(a["t"].view(torch.int32), b["t"].view(torch.int32))
    rec = torch.stack([(a[k].view(torch.int32) == b[k].view(torch.int32))
                       if a[k].dtype == torch.float32 else a[k] == b[k]
                       for k in b], 0).all(dim=0).float().mean().item()
    hits = (a["t"] < INF).float().mean().item()
    check(t_equal and rec >= 0.999,
          f"nearest_hit on the flake: t bit-equal {t_equal}, records "
          f"{rec:.6f}")
    pc, ms, launches = flake_walks("nearest_hit", ci.nearest_hit,
                                   ci.nearest_hit_counts, ci.nearest_hit_plain,
                                   (pk, ro, rd), live)
    n = int(live.sum())
    per = {k: pc[f"hit_{k}"] / n for k in ("spheres", "boxes", "tris")}
    bnd = bound(B * 24 + B * 4 * HIT_ROWS, walk_ops(pc) * B / n)
    out["nearest_hit"] = dict(ms=ms, launches=launches, per_walk=per,
                              records_equal=rec, **bnd)
    print(f"[flake] nearest_hit on {B} camera rays ({hits:.4f} hit): t "
          f"bit-equal to the brute force on every ray, records on {rec:.6f};"
          f" {per['spheres']:.2f} sphere and {per['boxes']:.2f} box tests a "
          f"walk against {linear} linear; {ms:.3f} ms kernel, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, the walks' counted "
          f"tests scaled from {n} lanes)")
    check(per["spheres"] * 10 <= linear,
          f"nearest_hit on the flake: {per['spheres']} sphere tests a walk")

    # #2 on shadow rays from the camera hits to the three lights
    hit = a["flag"] > 0
    nrm = torch.stack([a["nx"], a["ny"], a["nz"]], -1)
    pos = ro + rd * torch.where(hit, a["t"], torch.zeros_like(a["t"]))[:, None]
    li = torch.clamp((u[0] * pk.nl).long(), max=pk.nl - 1)
    p1 = (pos + nrm * 1e-4).contiguous()
    srd, _, md = shadow_ray(p1, lt[li, 0:3])
    out["any_blocker"] = {}
    for rule in (True, False):
        va = ci.any_blocker(pk, p1, srd, md, rule, live=hit)
        vb = ci.any_blocker_plain(pk, p1, srd, md, rule, live=hit)
        differ = int((va != vb).sum())
        blocked = va[hit].float().mean().item()
        check(differ <= B * 1e-5,
              f"any_blocker on the flake (dielectrics_block={rule}): "
              f"{differ} verdicts differ")
        pc, ms, launches = flake_walks(
            "any_blocker", ci.any_blocker, ci.any_blocker_counts,
            ci.any_blocker_plain, (pk, p1, srd, md, rule), live & hit, hit)
        n = int((live & hit).sum())
        per = {k: pc[f"shadow_{k}"] / n for k in ("spheres", "boxes", "tris")}
        n_hit = int(hit.sum())
        bnd = bound(n_hit * 28 + 2 * B, walk_ops(pc) * n_hit / n)
        out["any_blocker"][f"dielectrics_block={rule}"] = dict(
            ms=ms, launches=launches, per_walk=per, verdicts_differ=differ,
            **bnd)
        print(f"[flake] any_blocker dielectrics_block={rule} on {n_hit} "
              f"shadow rays ({blocked:.4f} blocked): {differ} verdicts "
              f"differ from the brute force; {per['spheres']:.2f} sphere and"
              f" {per['boxes']:.2f} box tests a ray against {pk.ns} linear; "
              f"{ms:.3f} ms kernel, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']})")
        check(per["spheres"] * 10 <= pk.ns,
              f"any_blocker on the flake: {per['spheres']} sphere tests a ray")

    # #5 against its plain loop on a 480x270 frame
    w, h = FLAKE_SMALL_W, FLAKE_SMALL_H
    scam = make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h,
                       device="cuda")
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    sargs = (pk, lt, scam, idx % w, idx // w, SPP,
             RenderConfig(width=w, height=h, spp=SPP, eye_depth=4), key)
    img = cw.render_wavefront(*sargs)
    pc = cw.new_counts()
    ref, plain_ms = once_ms(lambda: cw.render_wavefront_plain(*sargs,
                                                              counts=pc))
    share = share_close(img, ref)
    rel = abs(img.mean().item() - ref.mean().item()) / max(
        ref.mean().item(), 1e-6)
    check(share >= 0.99 and rel < 1e-3,
          f"render_wavefront on the flake {w}x{h}: {share:.6f} of pixels "
          f"agree, mean rel {rel}")
    img_c, kc = cw.render_wavefront_counts(*sargs)
    check(torch.equal(img_c, img),
          "render_wavefront_counts on the flake: its image differs")
    hold_counts(f"render_wavefront sphereflake {w}x{h} spp {SPP}", kc, pc,
                cw.PLAIN_COUNTS, exact=False)
    print(f"[flake] render_wavefront {w}x{h} spp {SPP}: pixels within rtol "
          f"1e-4 / atol 1e-5 {share:.6f}, mean rel diff {rel:.3g}; plain "
          f"loop {plain_ms:.1f} ms")

    # #5 through the CLI at 1080p (tier auto: mega), then timed and counted
    OUT.mkdir(parents=True, exist_ok=True)
    txt = OUT / "sphereflake.txt"
    txt.write_text(synth.sphereflake_text(FLAKE_LEVELS))
    res = counted("flake_mega", txt, W, H, "auto", "flake_mega", counts)
    launches = {k: v for k, v in counts["flake_mega"].items() if v}
    check(res["tier"] == "mega" and launches == {"render_wavefront": 1},
          f"sphereflake through the CLI: tier {res['tier']}, launches "
          f"{launches}")
    idx = torch.arange(B, dtype=torch.int32, device="cuda")
    margs = (pk, lt, cam, idx % W, idx // W, SPP,
             RenderConfig(width=W, height=H, spp=SPP, eye_depth=4), key)
    ms = time_ms(lambda: cw.render_wavefront(*margs), 5)
    a_c, kc = cw.render_wavefront_counts(*margs)
    check(torch.equal(a_c, cw.render_wavefront(*margs)),
          "render_wavefront_counts on the flake at 1080p: its image differs")
    # the loop's fold_ins (a plain-only count) from the 480x270 frame
    bnd = bound(B * (8 + 12), mega_ops(dict(kc, iteration_keys=pc[
        "iteration_keys"])))
    it, sr = kc["iterations"], max(kc["shadow_rays"], 1)
    per = dict(hit_spheres=kc["hit_spheres"] / it,
               hit_boxes=kc["hit_boxes"] / it,
               shadow_spheres=kc["shadow_spheres"] / sr,
               shadow_boxes=kc["shadow_boxes"] / sr)
    check(per["hit_spheres"] * 10 <= linear
          and per["shadow_spheres"] * 10 <= pk.ns,
          f"render_wavefront on the flake: tests a walk {per}")
    eff = {k: lane_share(kc, k) for k in ("walk", "shade", "shadow")}
    wide = dict(walks_per_iteration=kc["wide_walks"] / it,
                steps=kc["wide_steps"],
                steps_per_walk=kc["wide_steps"] / max(kc["wide_walks"], 1))
    out["render_wavefront"] = dict(ms=ms, launches=launches,
                                   per_walk=per, counts=kc, simt=eff,
                                   wide=wide, cli_seconds=res["seconds"],
                                   **bnd)
    print(f"[flake] render_wavefront {W}x{H} spp {SPP} (the CLI's auto: "
          f"mega, launches {launches}): {ms:.3f} ms kernel; "
          f"counting build: {it} iterations, {kc['shadow_rays']} shadow "
          f"rays; a bounce {per['hit_spheres']:.2f} sphere and "
          f"{per['hit_boxes']:.2f} box tests against {linear} linear, a "
          f"shadow ray {per['shadow_spheres']:.2f} and "
          f"{per['shadow_boxes']:.2f} against {pk.ns}; wide rays walked by"
          f" their warp {kc['wide_walks']} ({wide['walks_per_iteration']:.4f}"
          f" of iterations) in {kc['wide_steps']} warp steps "
          f"({wide['steps_per_walk']:.2f} a walk); SIMT walk "
          f"{eff['walk']:.4f}, shade {eff['shade']:.4f}, shadow step "
          f"{eff['shadow']:.4f}; counted bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']}), {bnd['bound_ms'] / ms:.4f} of the kernel's")
    return out


def main() -> int:
    import faulthandler

    faulthandler.enable()     # a crash in native code prints where it was
    t_start = time.perf_counter()
    laps = [t_start]

    def lap(what: str) -> None:
        laps.append(time.perf_counter())
        print(f"[time] {what}: {laps[-1] - laps[-2]:.1f} s")

    name = phase_card()
    phase_build()
    occupancy = phase_occupancy()
    lap("card, build, occupancy")

    from path_tracing_tpu_torch.scene import synth
    from path_tracing_tpu_torch.scene.camera import make_camera
    from path_tracing_tpu_torch.scene.parser import load_scene

    p = load_scene(str(SCENE))
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H,
                      device="cuda")
    m = synth.icosphere_scene(SMALL_MESH_TRIS, textured=True)
    mesh_cam = make_camera(m.eye, m.look_at, m.view_up, m.fov, W, H,
                           device="cuda")
    counts: dict = {}
    results, tex_small_err = phase_kernels(
        p.to_device("cuda"), cam, m.to_device("cuda"), mesh_cam, counts)
    rows = {r["name"]: r for r in results}
    retime_nearest_hit(p, rows["nearest_hit"])
    results.append(phase_bdpt_light(p))
    lap("kernels (phase 3)")
    split, small = phase_render(counts)
    results += phase_lanes(split, small, counts, rows)
    del split, small
    lap("PT renders and #1/#2 launches (phase 4)")
    results += phase_textured(counts, tex_small_err)
    lap("textured (phase 5)")
    bdpt_results, ris_img = phase_bdpt_kernels(p, cam)
    lap("BDPT kernels (phase 6)")
    for r in bdpt_results:
        r["occupancy"] = occupancy["exact" if r["name"] == "connect"
                                   else "tile-RIS"][r["name"]]
    results += bdpt_results
    conn = next(r for r in bdpt_results if r["name"] == "connect")
    conn["per_launch"], hits = phase_bdpt_render(counts, ris_img)
    rows["nearest_hit"]["bdpt_fused"] = dict(
        launches=len(hits), ms=sum(r["ms"] for r in hits), per_launch=hits)
    conn["oracle"] = phase_oracle(counts)
    lap("BDPT renders and the oracle (phase 7)")
    ppm_results, pass0 = phase_ppm_kernels(p, counts)
    results += ppm_results
    rows.update((r["name"], r) for r in ppm_results)
    phase_ppm_render(counts, pass0)
    lap("PPM (phases 8-9)")
    t0 = time.perf_counter()
    mesh = synth.icosphere_scene(BIG_TRIS, textured=True)
    print(f"[mesh] {BIG_TRIS}-triangle textured icosphere synthesised in "
          f"{time.perf_counter() - t0:.1f} s")
    mesh_results, obj, big = phase_mesh_kernels(counts, mesh)
    rows["nearest_hit"]["big_mesh"] = big
    results += mesh_results
    lap("mesh kernels (phase 10)")
    enclosed, txt = phase_tier_decision(counts, mesh, obj)
    del mesh
    lap("the tier decision (phase 11)")
    rows["nearest_hit"]["ppm_eye_big"], rows["photon_trace"]["big_mesh"] = \
        phase_big_ppm(counts, enclosed, txt)
    lap("big-mesh PPM (phase 12)")
    results.append(phase_big_bdpt(counts, enclosed, txt))
    del enclosed
    lap("big-mesh BDPT (phase 13)")
    phase_checkpoint()
    lap("checkpoint and profile (phase 14)")
    results += phase_legacy(counts)
    lap("legacy-Ks PT, BDPT and PPM (phase 15)")
    results.append(phase_sampled(counts))
    lap("sampled connections (phase 16)")
    results += phase_tex_integrators(counts)
    lap("textured BDPT and PPM (phase 17)")
    phase_hash_gather(counts)
    lap("the hash gather (phase 18)")
    phase_sharded()
    lap("sharded renders (phase 19)")
    phase_native(obj, txt)
    lap("the native runtime (phase 20)")
    for k, v in phase_flake(counts).items():
        rows[k]["flake"] = v
    lap("the sphereflake (phase 21)")
    for r in results:
        if r["name"] in occupancy:
            r["occupancy"] = occupancy[r["name"]]
        path = KERNEL_PATH[r["name"]]
        r.update(route="cuda", source=SOURCES.get(r["name"], PT_SOURCE),
                 replaces=REPLACES[r["name"]], path=path,
                 launches=counts[path][ENTRY.get(r["name"], r["name"])])
    keys = ("name", "route", "source", "replaces", "path", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("plain_lanes", "unsorted_ms", "per_bounce", "per_launch",
             "split_ms", "bdpt_fused", "oracle", "ppm_eye", "ppm_eye_big",
             "bdpt_light", "big_mesh", "floor_ms", "counts", "simt",
             "occupancy", "host_ms", "library_host_ms", "pass_ms",
             "pass_bound_ms", "pass_bound_by", "flake", "paths", "slots",
             "stored", "plain_host_ms", "side_ms", "side_loop_ms")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + extra if k in r} for r in results]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Textured PT in the PyTorch port against the JAX package: the OBJ/MTL/PNG
loader, the synthetic icospheres, the texture fields of the Scene, UV
interpolation and the bilinear atlas fetch, the ``with_uv`` nearest hit,
the textured bounce and the textured render.

The JAX side loads with its Python parsers (``PT_TPU_NO_NATIVE=1``) and
both packages build clusters with their default (native) builder, or the
JAX tables are carried across with ``scene_from_jax_arrays``; its Pallas kernels run in interpret mode.  Bars:
loader tables equal; the atlas fetch within rtol 1e-6; the nearest hit as
tests/test_torch_intersect.py (flags equal, t and UVs within 1e-5 on
99.95% of rays); the bounce as tests/test_torch_shade.py (every output
within rtol 1e-4 / atol 1e-5 on 99.9% of lanes); the render as
tests/test_torch_pt.py (mean within 1e-3, 99% of pixels within rtol 1e-4
/ atol 1e-5)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu.config import RenderConfig as JConfig
from path_tracing_tpu.film import write_png as j_write_png
from path_tracing_tpu.integrators.pt import _light_table as j_light_table
from path_tracing_tpu.integrators.pt import render_pt as j_render_pt
from path_tracing_tpu.ops import texture as jtexture
from path_tracing_tpu.ops.pallas_intersect import nearest_hit_pallas
from path_tracing_tpu.ops.pallas_intersect import pack_scene as jpack
from path_tracing_tpu.ops.pallas_shade import shade_step_tex_pallas
from path_tracing_tpu.scene import camera as jcamera
from path_tracing_tpu.scene import obj_loader as jobj
from path_tracing_tpu.scene import synth as jsynth
from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.film import read_png, write_png
from path_tracing_tpu_torch.integrators.pt import render_pt, resolve_tier
from path_tracing_tpu_torch.ops import cuda_intersect as CI
from path_tracing_tpu_torch.ops import cuda_shade, rng, texture
from path_tracing_tpu_torch.scene import obj_loader, synth
from path_tracing_tpu_torch.scene.camera import make_camera, primary_ray_dirs
from path_tracing_tpu_torch.scene.types import scene_from_jax_arrays

from conftest import make_textured_quad_obj
from test_torch_scene import jax_arrays

SPHERE_OBJ = Path(__file__).resolve().parent / "fixtures" / "sphere.obj"
W = H = 16
SPP = 2
CFG = dict(width=W, height=H, eye_depth=3, light_depth=3, delta_budget=3)
PARSED_FIELDS = ("eye", "look_at", "view_up", "fov", "width", "height",
                 "tri_verts", "tri_mtl", "tri_group", "lights", "tri_uv",
                 "tri_tex")


@pytest.fixture
def quad_obj(tmp_path):
    return make_textured_quad_obj(tmp_path)


def _jax_parsed(path, monkeypatch):
    monkeypatch.setenv("PT_TPU_NO_NATIVE", "1")
    return jobj.load_any_scene(str(path))


def _assert_parsed_equal(a, b):
    for f in PARSED_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert len(a.textures) == len(b.textures)
    for x, y in zip(a.textures, b.textures):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("which", ["sphere", "textured_quad"])
def test_obj_loading_matches_jax(which, quad_obj, monkeypatch):
    path = SPHERE_OBJ if which == "sphere" else Path(quad_obj)
    a = _jax_parsed(path, monkeypatch)
    b = obj_loader.load_any_scene(str(path))
    _assert_parsed_equal(a, b)
    _assert_parsed_equal(jobj.load_obj(str(path)),
                         obj_loader.load_obj(str(path)))
    if which == "textured_quad":
        assert b.tri_tex == [0, 0] and b.textures[0].shape == (8, 8, 3)
    else:
        assert len(b.tri_verts) > 1000 and set(b.tri_tex) == {-1}
    # the Scene's texture fields and atlas, each package on its default
    # (native) cluster builder
    d = jax_arrays(a.to_device())
    ts = b.to_device("cpu")
    for f in ("tri_v0", "tri_uv", "tri_tex", "tex_atlas", "tex_size",
              "tri_cluster_range"):
        np.testing.assert_array_equal(d[f], getattr(ts, f).numpy(),
                                      err_msg=f)
    assert ts.has_textures == (which == "textured_quad")


def test_read_png_round_trips(tmp_path):
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (7, 5, 3)).astype(np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)
    j_write_png(str(tmp_path / "b.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "b.png")), img)


def _png_with_every_filter(img):
    """An RGB8 PNG whose row i is stored with filter type i % 5 (None,
    Sub, Up, Average, Paeth), encoded here from the PNG specification."""
    import struct
    import zlib

    h, w, _ = img.shape
    raw, prev = b"", np.zeros(w * 3, np.int64)
    for i in range(h):
        line = img[i].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(3, np.int64), line[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        ft = i % 5
        if ft == 4:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        else:
            pred = [0 * line, left, prev, (left + prev) // 2, None][ft]
        raw += bytes([ft]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = line

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_read_png_decodes_every_row_filter(tmp_path):
    y, x = np.mgrid[0:10, 0:13]
    img = np.stack([(x * 37) % 256, (y * 71 + x * 5) % 256,
                    (x * y * 11) % 256], -1).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_every_filter(img))
    np.testing.assert_array_equal(read_png(str(path)), img)


@pytest.mark.parametrize("n_tris", [80, 1280])
def test_synth_matches_jax(n_tris):
    a, b = jsynth.icosphere(n_tris), synth.icosphere(n_tris)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(jsynth.checker_texture(),
                                  synth.checker_texture())
    jp = jsynth.icosphere_scene(n_tris, textured=True)
    tp = synth.icosphere_scene(n_tris, textured=True)
    _assert_parsed_equal(jp, tp)
    # each package's own Scene build (its default, native cluster
    # builder): the UVs and texture ids follow the cluster reorder
    d = jax_arrays(jp.to_device())
    ts = tp.to_device("cpu")
    assert ts.tri_cluster_range.shape[0] > 1     # the triangles reorder
    for f in ("tri_v0", "tri_v2", "tri_uv", "tri_tex", "tex_atlas",
              "tex_size", "tri_cluster_aabb", "tri_cluster_range"):
        np.testing.assert_array_equal(d[f], getattr(ts, f).numpy(),
                                      err_msg=f)


def test_write_obj_round_trips(tmp_path):
    s = synth.icosphere_scene(80, textured=True)
    r = obj_loader.load_any_scene(synth.write_obj(s, str(tmp_path / "i.obj")))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    np.testing.assert_array_equal(f32(s.tri_verts), f32(r.tri_verts))
    np.testing.assert_array_equal(f32(s.tri_uv), f32(r.tri_uv))
    np.testing.assert_array_equal(f32(s.tri_mtl), f32(r.tri_mtl))
    assert list(r.tri_tex) == list(s.tri_tex) and len(r.textures) == 1
    # texels through 8-bit gamma-encoded PNG: within half a code step
    np.testing.assert_allclose(r.textures[0], s.textures[0], atol=1e-2)
    np.testing.assert_array_equal(f32(r.lights), f32(s.lights))


def _atlas_scene():
    """A 2-texture atlas of unequal sizes, built by the port's parser."""
    rs = np.random.RandomState(3)
    p = synth.icosphere_scene(80, textured=True)
    p.textures = [rs.uniform(0, 1, (5, 7, 3)).astype(np.float32),
                  rs.uniform(0, 1, (9, 4, 3)).astype(np.float32)]
    return p.texture_atlas()


def test_sample_bilinear_matches_jax():
    atlas, size = _atlas_scene()
    assert atlas.shape == (2, 10, 8, 3)
    # the wrapped border: row h = row 0, col w = col 0
    np.testing.assert_array_equal(atlas[1, 9, :4], atlas[1, 0, :4])
    np.testing.assert_array_equal(atlas[0, :5, 7], atlas[0, :5, 0])
    rs = np.random.RandomState(4)
    n = 4096
    uv = rs.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    uv[:64] = np.round(uv[:64])            # the seam: integer coordinates
    uv[64:128] = -np.abs(uv[64:128]) * 1e-7  # just below zero
    tex_id = rs.randint(0, 2, n).astype(np.int32)
    a = np.asarray(jtexture.sample_bilinear(jnp.asarray(atlas),
                                            jnp.asarray(size),
                                            jnp.asarray(tex_id),
                                            jnp.asarray(uv)))
    b = texture.sample_bilinear(torch.from_numpy(atlas),
                                torch.from_numpy(size),
                                torch.from_numpy(tex_id),
                                torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
    uv6 = rs.uniform(0, 1, (n, 6)).astype(np.float32)
    u, v = rs.uniform(0, 0.5, (2, n)).astype(np.float32)
    np.testing.assert_allclose(
        texture.interpolate_uv(torch.from_numpy(uv6), torch.from_numpy(u),
                               torch.from_numpy(v)).numpy(),
        np.asarray(jtexture.interpolate_uv(jnp.asarray(uv6), jnp.asarray(u),
                                           jnp.asarray(v))),
        rtol=1e-6, atol=1e-7)


def _jax_mesh(n_tris, width=W, height=H):
    """The textured icosphere from the JAX package and the same tables
    carried over to the port on the CPU."""
    p = jsynth.icosphere_scene(n_tris, textured=True)
    js = p.to_device()
    jc = jcamera.make_camera(p.eye, p.look_at, p.view_up, p.fov, width,
                             height)
    ts, tc = scene_from_jax_arrays(jax_arrays(js, jc), "cpu")
    return js, jc, ts, tc


@pytest.fixture(scope="module")
def mesh():
    return _jax_mesh(1280, 64, 64)


def test_pack_scene_uv_table_matches_jax(mesh):
    js, _, ts, _ = mesh
    assert ts.has_textures and ts.num_triangles == 1280
    j_sph, j_tri, j_cl, *_ = jpack(js, with_uv=True)
    pk = CI.pack_scene(ts)
    a = np.asarray(j_tri)
    b = torch.cat([pk.tri, pk.uv[:, :7]], 1).numpy()
    assert a.shape == b.shape == (1280, 31)
    # the precomputed normals (columns 12-14) come from each framework's
    # cross product and norm, which round apart in the last bit
    nrm = np.zeros(31, bool)
    nrm[12:15] = True
    np.testing.assert_array_equal(a[:, ~nrm], b[:, ~nrm])
    np.testing.assert_allclose(a[:, nrm], b[:, nrm], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(j_cl), pk.cl.numpy())
    np.testing.assert_array_equal(np.asarray(js.tex_atlas), pk.atlas.numpy())


def _camera_state(tc, n, key):
    idx = torch.arange(n * n, dtype=torch.int32)
    u = rng.uniform_rows(rng.iter_key(key, 0), n * n, 8)
    rd = primary_ray_dirs(tc, idx % n, idx // n, u[6], u[7])
    return tc.eye[None].expand(n * n, 3).contiguous(), rd


def test_nearest_hit_with_uv_matches_pallas(mesh):
    js, _, ts, tc = mesh
    ro, rd = _camera_state(tc, 64, rng.prng_key(2))
    rs = np.random.RandomState(5)   # and rays from inside the sphere
    ro[:1024] = torch.from_numpy(rs.uniform(-0.5, 0.5, (1024, 3))
                                 .astype(np.float32))
    a = nearest_hit_pallas(js, jnp.asarray(ro.numpy()),
                           jnp.asarray(rd.numpy()), with_uv=True,
                           interpret=True)
    b = CI.nearest_hit(CI.pack_scene(ts), ro, rd, with_uv=True)
    np.testing.assert_array_equal(np.asarray(a["flag"]), b["flag"].numpy())
    hit = b["flag"].numpy() > 0
    assert 0.3 < hit.mean() < 1.0
    same_t = np.isclose(np.asarray(a["t"]), b["t"].numpy(), rtol=1e-5)
    assert same_t[hit].mean() >= 0.9995
    uv_ok = ((np.abs(np.asarray(a["iu"]) - b["iu"].numpy()) <= 1e-5)
             & (np.abs(np.asarray(a["iv"]) - b["iv"].numpy()) <= 1e-5)
             & (np.asarray(a["tex"]) == b["tex"].numpy()))
    assert uv_ok[hit].mean() >= 0.9995
    assert (b["tex"].numpy()[hit] == 0).all()
    assert (b["tex"].numpy()[~hit] == -1).all()


@pytest.mark.parametrize("stub_mis,dielectrics_block",
                         [(True, True), (False, False)])
def test_shade_step_tex_matches_pallas(mesh, stub_mis, dielectrics_block):
    """JAX's textured bounce is three steps (the with_uv Pallas nearest
    hit, the XLA atlas gather, shade_step_tex_pallas); the port's is one
    function.  Same tables, path state and uniforms."""
    js, _, ts, tc = mesh
    pk, lt = CI.pack_scene(ts), ts.packed.light
    key = rng.prng_key(8)
    ro, rd = _camera_state(tc, 64, key)
    B = ro.shape[0]
    kw = dict(clamp_val=15.0, stub_mis=stub_mis,
              dielectrics_block=dielectrics_block)
    st = dict(ro=ro, rd=rd, tp=torch.ones(B, 3), eta=torch.ones(B),
              depth=torch.zeros(B, dtype=torch.int32),
              alive=torch.ones(B, dtype=torch.bool),
              last_is_delta=torch.ones(B, dtype=torch.bool),
              last_pdf=torch.ones(B))
    u = rng.uniform_rows(rng.iter_key(key, 0), B, 8)
    out = cuda_shade.shade_step_tex(pk, lt, *st.values(), u, **kw)
    # half the lanes at their camera ray, half after one bounce (outward
    # rays that reach the light ball or miss, and lanes that died)
    cam_lane = torch.arange(B) % 2 == 0
    st = {k: torch.where(cam_lane if v.dim() == 1 else cam_lane[:, None],
                         v, out[k]) for k, v in st.items()}
    u = rng.uniform_rows(rng.iter_key(key, 1), B, 8)
    got = cuda_shade.shade_step_tex(pk, lt, *st.values(), u, **kw)

    j = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    ju = tuple(jnp.asarray(u[i].numpy()) for i in range(6))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PT_TPU_INTERPRET", "1")
        jax.clear_caches()
        h = nearest_hit_pallas(js, j["ro"], j["rd"], with_uv=True)
        tex_id = h["tex"].astype(jnp.int32)
        texel = jtexture.sample_bilinear(js.tex_atlas, js.tex_size, tex_id,
                                         jnp.stack([h["iu"], h["iv"]], -1))
        bc = jnp.stack([h["bcr"], h["bcg"], h["bcb"]], -1)
        bc_mod = jnp.where((tex_id >= 0)[:, None], bc * texel, bc)
        ref = shade_step_tex_pallas(js, j_light_table(js), h, bc_mod,
                                    *j.values(), ju, **kw)
    jax.clear_caches()
    for f in got:
        a, b = np.asarray(ref[f]), got[f].numpy()
        assert a.shape == b.shape, f
        ok = np.isclose(a.astype(np.float64), b.astype(np.float64),
                        rtol=1e-4, atol=1e-5)
        if ok.ndim > 1:
            ok = ok.all(axis=1)
        assert ok.mean() >= 0.999, (f, ok.mean())
    assert float(got["radiance"].sum()) > 0.0


def _bar(a, b, pixel_share):
    assert np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-6) < 1e-3
    close = np.isclose(a, b, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= pixel_share, close.mean()


@pytest.mark.parametrize("which", ["textured_quad", "icosphere_1280"])
def test_textured_render_matches_jax_fused_tex(which, quad_obj,
                                               monkeypatch):
    if which == "textured_quad":
        p = _jax_parsed(quad_obj, monkeypatch)
        js = p.to_device()
        jc = jcamera.make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H)
        ts, tc = scene_from_jax_arrays(jax_arrays(js, jc), "cpu")
    else:
        js, jc, ts, tc = _jax_mesh(1280)
    assert resolve_tier(ts, "auto") == "fused"
    img = render_pt(ts, tc, W, H, SPP, RenderConfig(**CFG),
                    rng.prng_key(0)).numpy()
    assert img.shape == (W * H, 3) and img.mean() > 0.0
    monkeypatch.setenv("PT_TPU_INTERPRET", "1")
    monkeypatch.setenv("PT_TPU_NO_MEGAKERNEL", "1")
    jax.clear_caches()
    try:
        ref = np.asarray(j_render_pt(js, jc, W, H, SPP, JConfig(**CFG),
                                     jax.random.PRNGKey(0)))
    finally:
        jax.clear_caches()
    _bar(ref, img, 0.99)


def test_mega_tier_refuses_textured_scene(quad_obj):
    """The megakernel is gated off textured scenes, as on the TPU: "auto"
    takes the per-bounce tier and "mega" raises instead of rendering in
    another tier."""
    ts = obj_loader.load_any_scene(quad_obj).to_device("cpu")
    assert ts.has_textures
    for tier in ("auto", "fused", "split", "plain"):
        assert resolve_tier(ts, tier) == ("fused" if tier == "auto"
                                          else tier)
    with pytest.raises(ValueError, match="mega"):
        render_pt(ts, None, 4, 4, 1, RenderConfig(**CFG), rng.prng_key(0),
                  tier="mega")


# ---- the PNG reader on every format a texture may come in ----

# (colour type, bit depth): grey 1/2/4/8, RGB 8/16, palette 1/2/4/8, grey +
# alpha 8/16, RGBA 8/16
PNG_FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (2, 16), (3, 1),
               (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _encode_png(samples, bit, color, plte=None, trns=None):
    """A PNG from integer samples (H, W * channels), written here from the
    PNG specification: samples packed at ``bit`` bits (16: big-endian),
    row i stored with filter i % 5 over the format's bytes per pixel."""
    import struct
    import zlib

    h = samples.shape[0]
    w = samples.shape[1] // PNG_CHANNELS[color]
    if bit == 16:
        rows = samples.astype(">u2").view(np.uint8).reshape(h, -1)
    elif bit == 8:
        rows = samples.astype(np.uint8)
    else:
        bits = np.unpackbits(samples.astype(np.uint8)[..., None],
                             axis=2)[..., 8 - bit:].reshape(h, -1)
        rows = np.packbits(bits, axis=1)
    bpp = max(1, PNG_CHANNELS[color] * bit // 8)
    raw, prev = b"", np.zeros(rows.shape[1], np.int64)
    for i in range(h):
        line = rows[i].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        ft = i % 5
        if ft == 4:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        else:
            pred = [0 * line, left, prev, (left + prev) // 2, None][ft]
        raw += bytes([ft]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = line

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    out = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit, color, 0, 0,
                                        0)))
    if plte is not None:
        out += chunk(b"PLTE", plte)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _random_png(color, bit, h=9, w=11, seed=0):
    rs = np.random.RandomState(seed)
    samples = rs.randint(0, 1 << bit, (h, w * PNG_CHANNELS[color]))
    plte = trns = None
    if color == 3:
        plte = rs.randint(0, 256, (1 << bit, 3)).astype(np.uint8).tobytes()
        trns = bytes([0, 128])
    return _encode_png(samples, bit, color, plte, trns)


@pytest.mark.parametrize("color,bit", PNG_FORMATS,
                         ids=[f"type{c}_{b}bit" for c, b in PNG_FORMATS])
def test_read_png_matches_pil(color, bit, tmp_path):
    """read_png returns what PIL's convert("RGB") returns: grey scaled to
    0-255, 16-bit samples as their high byte, palettes looked up, alpha
    and tRNS dropped; every row filter over the format's pixel width."""
    Image = pytest.importorskip("PIL.Image")
    path = tmp_path / "t.png"
    path.write_bytes(_random_png(color, bit))
    got = read_png(str(path))
    assert got.shape == (9, 11, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(str(path)).convert("RGB")))


@pytest.mark.parametrize("color,bit,interlace", [(0, 16, 0), (2, 8, 1)])
def test_read_png_refuses_other_formats(color, bit, interlace, tmp_path):
    import struct

    data = bytearray(_random_png(0, 8))
    data[16:29] = struct.pack(">IIBBBBB", 11, 9, bit, color, 0, 0, interlace)
    path = tmp_path / "x.png"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=f"colour type {color} at bit depth "
                                         f"{bit}"):
        read_png(str(path))


def _quad_with_png(dirpath, png_bytes, name):
    """The textured quad of conftest.make_textured_quad_obj with its map_Kd
    replaced by ``png_bytes``."""
    d = Path(dirpath) / name
    d.mkdir()
    obj = Path(make_textured_quad_obj(d))
    (d / "check.png").write_bytes(png_bytes)
    return obj


@pytest.mark.parametrize("fmt", ["rgba", "grey", "palette"])
def test_textured_obj_without_pil_keeps_its_texture(fmt, tmp_path,
                                                    monkeypatch):
    """A map_Kd in RGBA, grey or palette form is decoded by read_png when
    PIL cannot be imported: the OBJ loads with the texture (not the flat
    Kd) and renders exactly as the same texture stored as RGB8."""
    n = 8
    y, x = np.mgrid[0:n, 0:n]
    idx = ((y >= n // 2) * 2 + (x >= n // 2)).astype(np.int64)  # quadrants
    pal = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 255]])
    if fmt == "rgba":
        samples = np.concatenate([pal[idx], 77 + idx[..., None] * 40],
                                 -1).reshape(n, -1)
        png = _encode_png(samples, 8, 6)
        rgb = pal[idx]
    elif fmt == "grey":
        png = _encode_png(idx * 60 + 20, 8, 0)
        rgb = np.repeat((idx * 60 + 20)[..., None], 3, axis=2)
    else:
        png = _encode_png(idx, 2, 3, pal.astype(np.uint8).tobytes())
        rgb = pal[idx]
    twin = _quad_with_png(tmp_path, b"", "rgb8")
    write_png(str(twin.parent / "check.png"), rgb.astype(np.uint8))
    obj = _quad_with_png(tmp_path, png, fmt)

    import sys
    monkeypatch.setitem(sys.modules, "PIL", None)   # no PIL: read_png
    parsed = obj_loader.load_any_scene(str(obj))
    ref = obj_loader.load_any_scene(str(twin))
    assert len(parsed.textures) == 1 and list(parsed.tri_tex) == [0, 0]
    np.testing.assert_array_equal(parsed.textures[0], ref.textures[0])
    cfg = RenderConfig(width=8, height=8, eye_depth=2, delta_budget=2)
    imgs = []
    for p in (parsed, ref):
        scene = p.to_device("cpu")
        cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, 8, 8,
                          device="cpu")
        imgs.append(render_pt(scene, cam, 8, 8, 1, cfg, rng.prng_key(0)))
    assert torch.equal(imgs[0], imgs[1]) and imgs[0].mean() > 0.0


def test_unreadable_texture_warns_and_keeps_flat_kd(tmp_path, monkeypatch,
                                                    capsys):
    import sys
    monkeypatch.setitem(sys.modules, "PIL", None)
    obj = _quad_with_png(tmp_path, b"not a png", "bad")
    parsed = obj_loader.load_any_scene(str(obj))
    assert parsed.textures == [] and list(parsed.tri_tex) == [-1, -1]
    err = capsys.readouterr().err
    assert "check.png" in err and "flat Kd" in err

"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch versions that the benchmark's cells reach (Threefry, the text and
OBJ parsers, the numpy cluster builder, the brute-force intersection and
its walk models, the BSDFs, textures, the PT per-bounce loop, BDPT's light
trace, RIS tables and eye pass, PPM's eye pass, photon trace and exact
join), taken when the benchmark was defined.  Its imports are relative,
so it imports nothing of the program, and it holds no kernel wrapper:
every function runs in plain PyTorch on whatever device its tensors are
on.  It reads nothing the program made: ``check.py`` has it parse the
scene file again and render the compared pixels from the seed."""

"""The configurations of record as avatar specs.

The port's copy of ``BENCH_CONFIGS`` in ``tpukernels/aot.py``, with the
same values: for each registry key its operands as ``("f32"|"i32",
shape)`` (shape ``()`` is a host scalar) and its statics. The serving
daemon's default bucket table (``serve/bucketing.py``) is this table,
so a request padded up to an avatar runs at a configuration of record.

This module holds only the table. The reference's compile discipline
around it (precompile, the executable memo's manifest, ``aot_smoke``)
joins it with ROADMAP.md Queue A item 5. Standard library only.
"""

BENCH_CONFIGS = {
    "vector_add": {
        "args": (("f32", ()), ("f32", (1 << 20,)), ("f32", (1 << 20,))),
        "statics": {},
    },
    "sgemm": {
        "args": (("f32", ()), ("f32", (1024, 1024)), ("f32", (1024, 1024)),
                 ("f32", ()), ("f32", (1024, 1024))),
        "statics": {},
    },
    "stencil2d": {
        "args": (("f32", (4096, 4096)),),
        "statics": {"iters": 8},
    },
    "stencil3d": {
        "args": (("f32", (384, 384, 384)),),
        "statics": {"iters": 8},
    },
    "scan": {
        "args": (("i32", (1 << 22,)),),
        "statics": {},
    },
    "scan_exclusive": {
        "args": (("i32", (1 << 22,)),),
        "statics": {},
    },
    "histogram": {
        "args": (("i32", (1 << 22,)),),
        "statics": {"nbins": 256},
    },
    "scan_histogram": {
        "args": (("i32", (1 << 22,)),),
        "statics": {"nbins": 256},
    },
    "nbody": {
        # dt, eps and steps are the C adapter's defaults
        "args": (("f32", (65536,)),) * 7,
        "statics": {"dt": 1e-3, "eps": 1e-2, "steps": 1},
    },
}

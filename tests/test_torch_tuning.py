"""The port's tuning layer on the CPU: search spaces, the shared-memory
model, the persistent cache, and the precedence env > cache > default.

Mirrors the reference's ``tests/test_tuning.py`` with the card's
numbers. Every test points ``TPKT_TUNING_CACHE_DIR`` at its own
``tmp_path``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tpukernels.kernels import sgemm as J
from tpukernels_torch import registry
from tpukernels_torch.kernels import nbody as N
from tpukernels_torch.kernels import scan as SC
from tpukernels_torch.kernels import scan_histogram as SH
from tpukernels_torch.kernels import sgemm as S
from tpukernels_torch.kernels import stencil as ST
from tpukernels_torch.tuning import SMEM_BUDGET_BYTES, cache, resolve

SHA = "a" * 40


@pytest.fixture(autouse=True)
def tcache(tmp_path, monkeypatch):
    """An empty cache of the test's own, a fixed source sha, no knob
    set, clean counters."""
    d = tmp_path / "tcache"
    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(d))
    monkeypatch.delenv("TPKT_TUNING_CACHE", raising=False)
    for knob in ("BM", "BN", "BK", "DEPTH", "ORDER", "PRECISION"):
        monkeypatch.delenv(f"TPKT_SGEMM_{knob}", raising=False)
    for env in ("TPKT_STENCIL_K", "TPKT_SCAN_TILE", "TPKT_NBODY_BI",
                "TPKT_NBODY_BJ", "TPKT_SCANHIST_FUSE"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setattr(cache, "source_sha", lambda sources, root=None: SHA)
    monkeypatch.setattr(cache, "_REJECT_NOTED", set())
    monkeypatch.setattr(cache, "COUNTS", dict.fromkeys(cache.COUNTS, 0))
    cache.forget()
    return d


def _edit_entry(field, value):
    """Edit the file as another process would, then stop waiting out
    the memo's recheck interval."""
    p = cache.path()
    with open(p) as f:
        data = json.load(f)
    next(iter(data["entries"].values()))[field] = value
    with open(p, "w") as f:
        json.dump(data, f)
    cache.forget()


# ------------------------------------------------------------------ #
# search space: the shared-memory model, pruning, env parsing          #
# ------------------------------------------------------------------ #

def test_sgemm_smem_arithmetic_and_pruning():
    """The model's numbers on the card: every depth is one kernel (TMA +
    wgmma) on a ring of max(depth, 2) stages of NOPS x (bm + bn) x 64
    elements, plus 1024 B of alignment and two 8-byte mbarriers a stage.
    Split3 at 128x64: 99 360 B at depth 1 and 2 (the same two-stage
    instantiation), 148 528 B at depth 3; at 128x128, depth 3, 197 680 B.
    Every built tile fits at every depth, and a bm preference of 256 is
    pruned at depth 3 (depth 1 counts the largest tile it builds within
    the preferences, so it fits)."""
    control = {"bm": 128, "bn": 64, "bk": 64, "depth": 1, "order": "ij"}
    assert S._smem_bytes(control) == 99_360
    assert S._smem_bytes({**control, "depth": 2}) == 99_360
    assert S._smem_bytes({**control, "depth": 3}) == 148_528
    assert S._smem_bytes(control, precision="float32") == 148_512
    assert S._smem_bytes(control, precision="default") == 50_208
    for depth in (2, 3):  # depth·stage + 1024 + 16·depth
        for prec, nops, elem in (("high", 2, 2), ("float32", 3, 2),
                                 ("default", 1, 2)):
            assert S._smem_bytes({**control, "depth": depth},
                                 precision=prec) == \
                depth * nops * (128 + 64) * 64 * elem + 1024 + 16 * depth
    widest = {"bm": 128, "bn": 128, "bk": 64, "depth": 3}
    assert S._smem_bytes(widest) == 197_680 <= SMEM_BUDGET_BYTES == 232_448
    # three pieces an operand: float32 at 128x128 fits two stages only
    assert S._smem_bytes({**widest, "depth": 2}, precision="float32") \
        == 197_664
    assert S._smem_bytes(widest, precision="float32") == 295_984
    assert not S.TUNABLES.feasible({**widest, "bm": 256, "depth": 3})
    assert S.TUNABLES.feasible({**widest, "bm": 256, "depth": 1})

    cands, pruned = S.TUNABLES.candidates()
    assert cands[0] == control and pruned == 0
    assert len(cands) == 2 * 2 * 1 * 3 * 2
    # with bm 256 among the sweep values the model prunes, in both
    # orders, depth 3 at bm 256 (both bn); depth 1 and 2 fit
    bm = dataclasses.replace(S.TUNABLES.tunables[0], values=(256, 128, 64))
    wide = dataclasses.replace(
        S.TUNABLES, tunables=(bm, *S.TUNABLES.tunables[1:]))
    cands, pruned = wide.candidates()
    assert pruned == 4 and len(cands) == 36 - 4
    assert all(wide.feasible(c) for c in cands)


def test_env_parse_fail_loud(monkeypatch):
    for bad in ("0", "-8", "abc"):
        monkeypatch.setenv("TPKT_SGEMM_BM", bad)
        with pytest.raises(ValueError, match="TPKT_SGEMM_BM"):
            resolve(S.TUNABLES)
    monkeypatch.delenv("TPKT_SGEMM_BM")
    monkeypatch.setenv("TPKT_SGEMM_DEPTH", "4")
    with pytest.raises(ValueError, match="TPKT_SGEMM_DEPTH.*up to 3"):
        resolve(S.TUNABLES)
    monkeypatch.delenv("TPKT_SGEMM_DEPTH")
    monkeypatch.setenv("TPKT_SCANHIST_FUSE", "maybe")
    with pytest.raises(ValueError, match="TPKT_SCANHIST_FUSE"):
        resolve(SH.TUNABLES)


def test_env_for_and_quick_candidates():
    assert S.TUNABLES.env_for({"bm": 64, "depth": 2, "order": None}) == {
        "TPKT_SGEMM_BM": "64", "TPKT_SGEMM_DEPTH": "2"}
    quick = S.TUNABLES.quick_candidates()
    assert [c["bm"] for c in quick] == [128, 64]
    assert quick[0] == S.TUNABLES.defaults()


# ------------------------------------------------------------------ #
# cache: round trip, key, invalidation, disable switch                 #
# ------------------------------------------------------------------ #

def test_cache_roundtrip_and_key(tcache):
    params = {"bm": 64, "depth": 2, "order": "ji"}
    key = cache.put(S.TUNABLES, params, shape=(1024, 1024, 1024),
                    dtype="float32", kind="cpu", value=10.0, control=9.0)
    assert key == "sgemm|1024x1024x1024|float32|cpu"
    assert cache.path() == str(tcache / "tuning.json")
    entry = json.loads((tcache / "tuning.json").read_text())["entries"][key]
    assert entry["torch"] == torch.__version__
    assert entry["cuda"] == torch.version.cuda and entry["source_sha"] == SHA
    assert cache.get(S.TUNABLES, (1024, 1024, 1024), "float32",
                     kind="cpu") == params
    # another shape, dtype or card: a miss, never a fuzzy match
    assert cache.get(S.TUNABLES, (2048,) * 3, "float32", kind="cpu") is None
    assert cache.get(S.TUNABLES, (1024,) * 3, "bfloat16", kind="cpu") is None
    assert cache.get(S.TUNABLES, (1024,) * 3, "float32",
                     kind="nvidia_h100_80gb_hbm3") is None
    assert cache.COUNTS["hits"] == 1 and cache.COUNTS["misses"] == 3
    assert cache.device_kind("cpu") == "cpu"
    assert cache.canon_dtype(torch.int32) == "int32"


def test_put_keeps_other_entries_and_leaves_no_temporary(tcache):
    cache.put(S.TUNABLES, {"bm": 64}, shape=(8, 8, 8), kind="cpu")
    cache.put(S.TUNABLES, {"depth": 3}, shape=(16, 16, 16), kind="cpu")
    assert cache.get(S.TUNABLES, (8, 8, 8), kind="cpu") == {"bm": 64}
    assert cache.get(S.TUNABLES, (16, 16, 16), kind="cpu") == {"depth": 3}
    assert sorted(p.name for p in tcache.iterdir()) == [
        "tuning.json", "tuning.json.lock"]


@pytest.mark.parametrize("field,value,reason", [
    ("torch", "0.0.1", "tuned on torch 0.0.1"),
    ("cuda", "0.1", "tuned on CUDA 0.1"),
    ("source_sha", "f" * 40, "stale: a commit touching"),
])
def test_cache_invalidation_is_loud(capsys, field, value, reason):
    shape = (64, 64, 64)
    cache.put(S.TUNABLES, {"depth": 2}, shape=shape, dtype="float32",
              kind="cpu")
    _edit_entry(field, value)
    for _ in range(3):  # counted each time, told once
        assert cache.get(S.TUNABLES, shape, "float32", kind="cpu") is None
    err = [line for line in capsys.readouterr().err.splitlines()
           if "tuning-cache rejected" in line]
    assert len(err) == 1 and reason in err[0]
    assert "sgemm|64x64x64|float32|cpu" in err[0]
    assert cache.COUNTS["rejections"] == 3
    # healed, the entry is read again
    cache.put(S.TUNABLES, {"depth": 2}, shape=shape, dtype="float32",
              kind="cpu")
    assert cache.get(S.TUNABLES, shape, "float32", kind="cpu") == {"depth": 2}


def test_no_sha_outside_git_skips_the_sha_check(monkeypatch):
    cache.put(S.TUNABLES, {"depth": 2}, shape=(8, 8, 8), kind="cpu")
    _edit_entry("source_sha", "f" * 40)
    monkeypatch.setattr(cache, "source_sha", lambda sources, root=None: None)
    assert cache.get(S.TUNABLES, (8, 8, 8), kind="cpu") == {"depth": 2}


def test_source_sha_of_the_real_sources_is_a_sha_or_none():
    # the real helper (the fixture replaced it): a commit sha, or None
    # outside a git checkout; never raises
    sha = cache._git("log", "-1", "--format=%H", "--", *S.TUNABLES.sources)
    assert sha is None or len(sha) == 40


@pytest.mark.parametrize("off", ["0", "off", "none", "OFF"])
def test_cache_disable_knob(monkeypatch, off):
    cache.put(S.TUNABLES, {"depth": 2}, shape=(8, 8, 8), kind="cpu")
    assert cache.get(S.TUNABLES, (8, 8, 8), kind="cpu") is not None
    monkeypatch.setenv("TPKT_TUNING_CACHE", off)
    assert cache.get(S.TUNABLES, (8, 8, 8), kind="cpu") is None
    assert resolve(S.TUNABLES, (8, 8, 8), device="cpu")["depth"] == 1


def test_another_process_write_is_seen_after_the_recheck(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(cache.time, "monotonic", lambda: clock[0])
    assert cache.get(S.TUNABLES, (8, 8, 8), kind="cpu") is None
    cache.put(S.TUNABLES, {"depth": 2}, shape=(8, 8, 8), kind="cpu")
    assert cache.get(S.TUNABLES, (8, 8, 8), kind="cpu") == {"depth": 2}
    _edit_entry("params", {"depth": 3})  # forgets: seen at once
    assert cache.get(S.TUNABLES, (8, 8, 8), kind="cpu") == {"depth": 3}
    p = cache.path()
    data = json.loads(open(p).read())
    next(iter(data["entries"].values()))["params"] = {"depth": 1}
    with open(p, "w") as f:
        json.dump(data, f)
    assert cache.get(S.TUNABLES, (8, 8, 8), kind="cpu") == {"depth": 3}
    clock[0] += cache.RECHECK_S
    assert cache.get(S.TUNABLES, (8, 8, 8), kind="cpu") == {"depth": 1}


def test_torn_cache_file_degrades_to_defaults(tcache, capsys):
    tcache.mkdir()
    (tcache / "tuning.json").write_text('{"entries": {"sgemm|')
    assert resolve(S.TUNABLES, (8, 8, 8), "float32", "cpu") == \
        S.TUNABLES.defaults()
    assert "torn artifact rejected" in capsys.readouterr().err


# ------------------------------------------------------------------ #
# precedence: env > cache > default                                    #
# ------------------------------------------------------------------ #

def test_resolve_precedence(monkeypatch):
    shape, dtype = (512, 512, 512), "float32"
    assert resolve(S.TUNABLES, shape, dtype, "cpu") == S.TUNABLES.defaults()

    cache.put(S.TUNABLES, {"bm": 64, "bk": 64, "depth": 3},
              shape=shape, dtype=dtype, kind="cpu")
    # knobs the entry lacks fall back to the defaults, one by one
    assert resolve(S.TUNABLES, shape, dtype, "cpu") == {
        "bm": 64, "bn": 64, "bk": 64, "depth": 3, "order": "ij"}
    assert registry.knob_sources("sgemm", shape, dtype, "cpu") == {
        "bm": "cache", "bn": "default", "bk": "cache", "depth": "cache",
        "order": "default"}

    # a set env knob beats the cache for its own knob only
    monkeypatch.setenv("TPKT_SGEMM_DEPTH", "2")
    assert registry.resolve_params("sgemm", shape, dtype, "cpu") == {
        "bm": 64, "bn": 64, "bk": 64, "depth": 2, "order": "ij"}
    assert registry.knob_sources("sgemm", shape, dtype, "cpu")["depth"] == \
        "env"
    monkeypatch.delenv("TPKT_SGEMM_DEPTH")
    assert registry.resolve_params("sgemm", shape, dtype, "cpu")["depth"] == 3
    # the wrapper's plan reads the same layers
    assert S.plan(512, 512, 512, device="cpu")["depth"] == 3


@pytest.mark.parametrize("bad", [{"depth": 7}, {"depth": "2"},
                                 {"order": "kij"}, {"bm": True},
                                 {"bk": -32}])
def test_bad_cached_value_is_rejected_and_the_default_used(capsys, bad):
    cache.put(S.TUNABLES, bad, shape=(8, 8, 8), dtype="float32", kind="cpu")
    got = resolve(S.TUNABLES, (8, 8, 8), "float32", "cpu")
    (name, _), = bad.items()
    assert got[name] == S.TUNABLES.defaults()[name]
    assert cache.COUNTS["rejections"] == 1
    assert f"bad cached value for {name}" in capsys.readouterr().err


def test_no_cache_entry_can_set_precision():
    """precision is not a knob of the space: a tuned entry cannot change
    which contract a result is held to."""
    assert "precision" not in {t.name for t in S.TUNABLES.tunables}
    rng = np.random.default_rng(3)
    a, b, c = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((40, 56), (56, 72), (40, 72)))
    cache.put(S.TUNABLES, {"precision": "float32", "depth": 2},
              shape=(40, 56, 72), dtype="float32", kind="cpu")
    assert "precision" not in resolve(S.TUNABLES, (40, 56, 72), "float32",
                                      "cpu")
    assert S.plan(40, 72, 56, device="cpu")["depth"] == 2  # entry read
    got = S.sgemm(1.5, a, b, 0.5, c)
    assert torch.equal(got, S.sgemm_plain(1.5, a, b, 0.5, c, "high"))
    assert not torch.equal(got, S.sgemm_plain(1.5, a, b, 0.5, c, "float32"))


# ------------------------------------------------------------------ #
# the wrappers key their lookups as the reference does                 #
# ------------------------------------------------------------------ #

def test_wrappers_read_entries_keyed_like_the_reference():
    rng = np.random.default_rng(0)
    put = lambda sp, params, shape, dtype: cache.put(  # noqa: E731
        sp, params, shape=shape, dtype=dtype, kind="cpu")
    put(ST.TUNABLES[0], {"k": 5}, (40, 200), "float32")
    put(ST.TUNABLES[1], {"k": 2}, (8, 24, 132), "float32")
    assert ST.resolve_k(None, 2, (40, 200), "cpu") == 5
    assert ST.resolve_k(None, 3, (8, 24, 132), "cpu") == 2
    assert ST.resolve_k(None, 2, (41, 200), "cpu") == 8  # another key
    x = torch.from_numpy(rng.integers(-9, 9, 5000, dtype=np.int32))
    put(SC.TUNABLES, {"tile": 1024}, (5000,), "int32")
    assert SC.resolve_tile(x) == 1024 and SC.resolve_tile() == 16384
    assert SC.resolve_tile(x.float()) == 16384  # the dtype is in the key
    put(N.TUNABLES, {"bi": 128, "bj": 512}, (192,), "float32")
    assert N._tiles(192, "cpu") == (128, 512)
    put(SH.TUNABLES, {"fuse": "on"}, (5000, 16), "int32")
    assert registry.resolve_params("scan_histogram", (5000, 16), "int32",
                                   "cpu") == {"fuse": "on"}
    for name, shape, dtype in (("vector_add", (1 << 20,), "float32"),
                               ("histogram", (1 << 22, 256), "int32")):
        sp = registry.tunables(name)
        assert (sp.bench_shape, sp.bench_dtype) == (shape, dtype)
        (knob, default), = sp.defaults().items()
        put(sp, {knob: default * 2}, shape, dtype)
        assert registry.resolve_params(name, shape, dtype, "cpu") == {
            knob: default * 2}


def test_registry_tunables_surface():
    assert set(registry.tunable_kernels()) == {
        "sgemm", "vector_add", "scan", "histogram", "scan_histogram",
        "nbody", "stencil2d", "stencil3d"}
    assert registry.tunables("scan_exclusive").kernel == "scan"
    for name in registry.tunable_kernels():
        sp = registry.tunables(name)
        assert sp.sources and sp.bench_shape and sp.bench_dtype
        for src in sp.sources:
            assert src.startswith("tpukernels_torch/")
            assert os.path.isfile(os.path.join(cache._REPO, src)), src
    assert registry.tunables("sgemm").bench_shape == (1024, 1024, 1024)


# ------------------------------------------------------------------ #
# the tile picker against the reference's                              #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("dim,preferred,align", [
    (2176, 1024, 128), (1042, 256, 8), (2176, 2048, 128), (1024, 256, 8),
    (300, 1024, 128), (129, 64, 8), (4096, 2048, 128), (1000, 512, 128),
    (130, 128, 8), (2049, 2048, 128),
])
def test_pick_block_matches_the_reference(dim, preferred, align):
    sizes = range(align, max(dim, preferred) + align, align)
    assert S._pick_block(dim, preferred, sizes) == J._pick_block(
        dim, preferred, align)


def test_pick_block_docstring_cases():
    # the reference's docstring: k=2176 keeps bk=1088-class tiles, not
    # 128; m=1042 not 8; n=2176 does not pad to 4096
    assert S._pick_block(2176, 1024, range(128, 2305, 128)) == \
        J._pick_block(2176, 1024, 128) != 128
    assert S._pick_block(1042, 256, range(8, 1056, 8)) == \
        J._pick_block(1042, 256, 8) != 8
    assert S._pick_block(2176, 2048, range(128, 2305, 128)) == \
        J._pick_block(2176, 2048, 128) != 2048
    # the built sizes: fewest blocks for 1024, least padding for 40
    assert S._pick_block(1024, 128, S.BM_SIZES) == 128
    assert S._pick_block(40, 128, S.BM_SIZES) == 64
    assert S._pick_block(300, 64, S.BK_SIZES) == 64


def test_env_raw_follows_os_environ(monkeypatch):
    """The memo's read of a variable sees what ``os.environ`` holds now:
    set, changed and unset through it; without the dict behind
    ``os.environ`` it falls back to ``os.environ.get``."""
    name = "TPKT_TEST_ENV_RAW"
    monkeypatch.delenv(name, raising=False)
    assert cache.env_raw(name) is None
    monkeypatch.setenv(name, "7")
    assert cache.env_raw(name) == os.fsencode("7")
    os.environ[name] = "8"
    assert cache.env_raw(name) == os.fsencode("8")
    del os.environ[name]
    assert cache.env_raw(name) is None
    monkeypatch.setattr(cache, "_ENV", None)
    monkeypatch.setenv(name, "9")
    assert cache.env_raw(name) == "9"
    monkeypatch.delenv(name)
    assert cache.env_raw(name) is None
    # the switch and the directory are read through it
    monkeypatch.undo()
    monkeypatch.setenv("TPKT_TUNING_CACHE", " OFF ")
    assert not cache.enabled()
    monkeypatch.delenv("TPKT_TUNING_CACHE")
    assert cache.enabled()


def test_plan_memo_follows_env_cache_and_switch(monkeypatch):
    """tuning.plan_memo: a hit while nothing changed; a new plan after a
    knob's env var, a cache entry or the cache switch changed."""
    from tpukernels_torch.tuning import plan_memo

    monkeypatch.setattr(cache.time, "monotonic", lambda: 100.0)
    made = []

    def make():
        made.append(1)
        return resolve(S.TUNABLES, (8, 8, 8), "float32", "cpu")["depth"]

    key = ((8, 8, 8), None)
    assert plan_memo(S.TUNABLES, key, make) == 1
    assert plan_memo(S.TUNABLES, key, make) == 1 and len(made) == 1
    monkeypatch.setenv("TPKT_SGEMM_DEPTH", "2")
    assert plan_memo(S.TUNABLES, key, make) == 2 and len(made) == 2
    monkeypatch.delenv("TPKT_SGEMM_DEPTH")
    assert plan_memo(S.TUNABLES, key, make) == 1 and len(made) == 2
    cache.put(S.TUNABLES, {"depth": 3}, shape=(8, 8, 8), dtype="float32",
              kind="cpu")
    assert plan_memo(S.TUNABLES, key, make) == 3 and len(made) == 3
    monkeypatch.setenv("TPKT_TUNING_CACHE", "off")
    assert plan_memo(S.TUNABLES, key, make) == 1 and len(made) == 4
    # another key is another plan; make takes the arguments given
    assert plan_memo(S.TUNABLES, ((9, 9, 9), None), make) == 1
    assert len(made) == 5
    assert plan_memo(S.TUNABLES, (0,), lambda *a: a, 4, 5) == (4, 5)


@pytest.mark.parametrize("depth", S.DEPTHS)
def test_plan_picks_only_the_tiles_of_the_kernel_depth_selects(monkeypatch,
                                                                depth):
    """Whatever the preferences and the shape, plan() returns a tile the
    kernel that ``depth`` selects is built for: bm 128/64 x bn 128/64 x
    bk 64 at every depth (sgemm.cu and sgemm_pipelined.cu instantiate
    one kernel), 128 x 64 x 64 at 1024^3 by default."""
    bms, bns, bks = S.tiles(depth)
    assert S.tiles(depth) == S.TILES[1 if depth == 1 else 2]
    monkeypatch.setenv("TPKT_SGEMM_DEPTH", str(depth))
    rng = np.random.default_rng(depth)
    checked = 0
    for _ in range(60):
        pref = {k: int(rng.choice([8, 32, 64, 96, 128, 256]))
                for k in ("bm", "bn", "bk")}
        if not S.TUNABLES.feasible({**pref, "depth": depth}):
            continue  # raises before any tile is picked
        for k, v in pref.items():
            monkeypatch.setenv(f"TPKT_SGEMM_{k.upper()}", str(v))
        m, n, k = (int(d) for d in rng.integers(1, 3000, 3))
        checked += 1
        p = S.plan(m, n, k, "default", "cpu")
        assert p["bm"] in bms and p["bn"] in bns and p["bk"] in bks, p
        assert p["depth"] == depth
    assert checked >= 20
    for k in ("BM", "BN", "BK"):
        monkeypatch.delenv(f"TPKT_SGEMM_{k}")
    want = {1: (128, 64, 64), 2: (128, 64, 64), 3: (128, 64, 64)}[depth]
    p = S.plan(1024, 1024, 1024, device="cpu")
    assert (p["bm"], p["bn"], p["bk"]) == want


@pytest.mark.parametrize("precision", S.PRECISIONS)
def test_depth1_smem_counts_two_stages_alignment_and_barriers(precision):
    """Depth 1 needs two stages of every operand tile, 1024 bytes to
    align the ring for the 128-byte swizzle and four 8-byte mbarriers;
    every tile it builds fits a block."""
    nops = {"high": 2, "float32": 3, "default": 1}[precision]
    elem = 2  # every operand is bf16
    bms, bns, bks = S.tiles(1)
    for bm in bms:
        for bn in bns:
            need = S._smem_bytes({"bm": bm, "bn": bn, "bk": bks[0],
                                  "depth": 1}, precision=precision)
            stage = nops * (bm + bn) * bks[0] * elem
            assert need == 2 * stage + 1024 + 32 <= SMEM_BUDGET_BYTES
    # a preference under the smallest built size counts as that size
    assert S._smem_bytes({"bm": 8, "bn": 8, "bk": 8, "depth": 1},
                         precision=precision) == \
        2 * nops * 128 * 64 * elem + 1056

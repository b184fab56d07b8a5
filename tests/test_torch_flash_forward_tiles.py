"""K7's float32 forward tiles, on the CPU: the steps a block walks, the
tile constants, the edge calls and the shared memory they need.

The CUDA prefill (``csrc/flash_attention.cu``; its float32 body in
``csrc/attn_fwd_f32.cuh``) has its tiles mirrored in
``kernels/flash_attention/cuda.py`` (``FWD_ROWS``, ``FWD_STEP``) with the
key steps a block walks (``fwd_key_steps``).  Those ranges are held to
``ref.attention_mask``: the steps that hold any visible (query, key) pair
of the block are exactly the ones it walks, under the causal mask, a
window, ``kv_len < Tk`` and ``q_offset > 0``.  The mirrored constants are
held to the ones parsed from the sources, and
``verify.flash_prefill_smem_bytes`` to the float32 layout's bytes.
``chip_smoke.fwd_edge_calls()`` must meet every float32 tile at
T = tile - 1, tile and tile + 1 at every built head dim, causal, windowed
and non-causal, and hold one call of more blocks than one wave of the
card; every edge call runs here through the port's plain K7 and agrees
with ``repro``'s ``attention_ref`` in float32 (normwise 1e-5, the chip
smoke's ``SERVE_TOL``; a row that sees no key is 0 in the port, where
``repro`` returns the mean of v: ROADMAP Queue 3).  The planted forward
fault is refused by the chip smoke's check on the CPU.
"""
import pathlib
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention.ref import attention_ref as repro_ref
from repro_torch.kernels.flash_attention import cuda as fa_cuda
from repro_torch.kernels.flash_attention import flash_attention_bh
from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                     flash_attention_bh_ref)
from repro_torch.verify import flash_prefill_smem_bytes

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
H100_SMS = 132
F32_BLOCKS_AN_SM = 4      # the most float32 prefill blocks an SM holds (d 64)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


# (rows a block, keys a step) of every built prefill tiling
TILINGS = sorted({(fa_cuda.FWD_ROWS[dt], step)
                  for dt, steps in fa_cuda.FWD_STEP.items()
                  for step in steps.values()})
# (Tq, Tk, kv_len, q_offset)
FORMS = [(31, 31, 31, 0), (32, 32, 32, 0), (33, 33, 33, 0), (64, 64, 64, 0),
         (65, 65, 65, 0), (100, 100, 100, 0), (257, 257, 257, 0),
         (70, 45, 45, 0), (45, 70, 70, 0), (90, 33, 33, 0),
         (17, 300, 201, 184), (40, 120, 100, 60), (16, 64, 44, 40),
         (33, 64, 50, 0), (8, 40, 3, 30)]
WINDOWS = (0, 4, 16, 40)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Tq,Tk,kv_len,q_offset", FORMS)
def test_key_steps_of_a_query_block_match_the_mask(Tq, Tk, kv_len,
                                                   q_offset, causal):
    """A prefill block walks exactly the key steps in which one of its
    rows sees some key, at every tiling and window."""
    for window in WINDOWS:
        mask = attention_mask(Tq, Tk, causal, window, kv_len, q_offset,
                              "cpu").expand(Tq, Tk)
        for rows, step in TILINGS:
            want = [sorted({int(j) // step for j in
                            mask[q0:q0 + rows].any(dim=0).nonzero()})
                    for q0 in range(0, Tq, rows)]
            got = [list(fa_cuda.fwd_key_steps(q0, rows, step, Tq, Tk,
                                              causal, window, kv_len,
                                              q_offset))
                   for q0 in range(0, Tq, rows)]
            assert got == want, (window, rows, step)


def _float32_tiles():
    """(rows a block, {d: keys a step}, {d: dynamic shared memory}) as
    ``attn_fwd_f32.cuh`` states them, evaluated at each built d."""
    src = (CSRC / "attn_fwd_f32.cuh").read_text()
    rows = int(re.search(r"constexpr int kRows = (\d+);", src)[1])
    m = re.search(r"kStep = D == (\d+) \? (\d+) : (\d+);", src)
    steps = {d: int(m[2]) if d == int(m[1]) else int(m[3])
             for d in fa_cuda.HEAD_DIMS}
    ld = int(re.search(r"kLd = D \+ (\d+);", src)[1])
    ldp = int(re.search(r"kLdP = kStep \+ (\d+);", src)[1])
    assert re.search(r"kBytes =\s+4 \* \(kRows \* kLd \+ 2 \* kStep \* kLd "
                     r"\+ kRows \* kLdP\);", src)
    smem = {d: 4 * (rows * (d + ld) + 2 * steps[d] * (d + ld)
                    + rows * (steps[d] + ldp)) for d in fa_cuda.HEAD_DIMS}
    return rows, steps, smem


def test_float32_tiles_are_the_kernels():
    """The float32 tiles cuda.py mirrors are the ones ``attn_fwd_f32.cuh``
    states (32 rows a block, 64 keys a step at d 64, 32 above), and the
    bf16 ones those of ``flash_attention.cu`` (64 rows, 64 keys)."""
    f32, bf16 = torch.float32, torch.bfloat16
    rows, steps, _ = _float32_tiles()
    assert fa_cuda.FWD_ROWS[f32] == rows == 32
    assert fa_cuda.FWD_STEP[f32] == steps
    assert steps[64] == 64 and {steps[d] for d in steps if d != 64} == {32}
    cu = (CSRC / "flash_attention.cu").read_text()
    warps = int(re.search(r"constexpr int kWarps = (\d+);", cu)[1])
    assert re.search(r"constexpr int kRows = 16 \* kWarps;", cu)
    keys = int(re.search(r"static constexpr int kKeys = (\d+);", cu)[1])
    assert fa_cuda.FWD_ROWS[bf16] == 16 * warps
    assert set(fa_cuda.FWD_STEP[bf16].values()) == {keys}


@pytest.mark.parametrize("d", fa_cuda.HEAD_DIMS)
def test_prefill_smem_bytes_follow_the_layout(d):
    """``flash_prefill_smem_bytes(4, d)``: Q, K, V and P as staged by
    ``attn_fwd_f32.cuh``; within the card's 227 KB a block, and four blocks
    an SM (of 228 KB, 1 KB a block reserved) up to d 128."""
    _, _, smem = _float32_tiles()
    got = flash_prefill_smem_bytes(4, d)
    assert got == smem[d]
    assert got <= 232448
    blocks = 233472 // (got + 1024)
    assert blocks >= (4 if d <= 128 else 2)


@pytest.mark.parametrize("form", ["causal", "window", "non-causal"])
@pytest.mark.parametrize("d", fa_cuda.HEAD_DIMS)
@pytest.mark.parametrize("tile", sorted({
    fa_cuda.FWD_ROWS[torch.float32],
    *fa_cuda.FWD_STEP[torch.float32].values()}))
def test_edge_calls_meet_every_float32_tile(tile, d, form):
    """T = tile - 1, tile, tile + 1 at each head dim, causal, causal with a
    window that masks inside the tile, and non-causal."""
    calls = _chip_smoke().fwd_edge_calls()
    for t in (tile - 1, tile, tile + 1):
        hits = [c for c in calls
                if c[1] == c[2] == c[6] == t and c[3] == d and c[7] == 0
                and c[4] == (form != "non-causal")
                and (0 < c[5] < t if form == "window" else c[5] == 0)]
        assert hits, (t, d, form)


def test_edge_calls_hold_the_other_forms():
    """Some call has kv_len < Tk with q_offset > 0, one a window there too,
    one rows that see no key, and one more blocks than one wave."""
    calls = _chip_smoke().fwd_edge_calls()
    assert any(c[6] < c[2] and c[7] > 0 for c in calls)
    assert any(c[6] < c[2] and c[7] > 0 and c[5] > 0 for c in calls)
    assert any(not attention_mask(c[1], c[2], c[4], c[5], c[6], c[7],
                                  "cpu").expand(c[1], c[2]).any(-1).all()
               for c in calls)
    rows = fa_cuda.FWD_ROWS[torch.float32]
    assert max(BH * -(-Tq // rows) for BH, Tq, *_ in calls) \
        > H100_SMS * F32_BLOCKS_AN_SM


def _edge_ids():
    return ["-".join(str(int(x)) for x in c)
            for c in _chip_smoke().fwd_edge_calls()]


@pytest.mark.parametrize("call", _chip_smoke().fwd_edge_calls(),
                         ids=_edge_ids())
def test_edge_call_matches_the_reference(call):
    """The port's plain K7 in float32 against ``repro``'s ``attention_ref``
    on the same seeded inputs: normwise within 1e-5 on the rows that see a
    key, 0 on the rest."""
    BH, Tq, Tk, d, causal, window, kv_len, q_offset = call
    rng = np.random.default_rng(BH + Tq + Tk + d + window + q_offset)
    q = rng.normal(size=(BH, Tq, d)).astype(np.float32)
    k, v = (rng.normal(size=(BH, Tk, d)).astype(np.float32)
            for _ in range(2))
    kw = dict(scale=d ** -0.5, causal=causal, window=window, kv_len=kv_len,
              q_offset=q_offset)
    got = flash_attention_bh(*(torch.from_numpy(x) for x in (q, k, v)),
                             **kw).numpy()
    want = np.asarray(repro_ref(*(jnp.asarray(x[:, None]) for x in
                                  (q, k, v)), **kw))[:, 0]
    seen = attention_mask(Tq, Tk, causal, window, kv_len, q_offset,
                          "cpu").expand(Tq, Tk).any(-1).numpy()
    diff = np.abs(got[:, seen] - want[:, seen]).max(initial=0.0)
    assert diff <= TOL * np.abs(want[:, seen]).max(initial=0.0)
    assert not got[:, ~seen].any()


def test_planted_forward_fault_is_refused():
    """On the CPU the plain forward passes ``fwd_problems`` and the plain
    forward with each row's last visible key dropped does not, on the call
    the chip smoke plants it on."""
    chip_smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    BH, T, d = 2, 65, 64
    q, k, v = (torch.randn(BH, T, d, generator=gen) for _ in range(3))
    a = dict(q=q, k=k, v=v, scale=d ** -0.5, causal=False, window=0,
             kv_len=T, q_offset=0)
    assert any(c[:5] == (BH, T, T, d, False) for c in
               chip_smoke.fwd_edge_calls())
    ok, err = chip_smoke.fwd_problems(chip_smoke.forward_lse(a), a)
    assert ok == [] and err == 0.0
    fault = flash_attention_bh_ref(q, k, v, scale=d ** -0.5, causal=False,
                                   kv_len=T - 1, return_lse=True)
    bad, err = chip_smoke.fwd_problems(fault, a)
    assert bad and err > chip_smoke.SERVE_TOL["float32"]

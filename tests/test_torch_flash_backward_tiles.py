"""K7's backward tiles, on the CPU: the steps a block walks and the edge calls.

The CUDA backward (``csrc/flash_attention_bwd.cu``, its float32 passes in
``csrc/attn_bwd_f32.cuh``) has its tiles mirrored in
``kernels/flash_attention/cuda.py`` (``BWD_ROWS``, ``BWD_STEP``) with the
steps a block walks (``bwd_query_steps`` for a dK / dV block,
``bwd_key_steps`` for a dQ block).  Those ranges are held to
``ref.attention_mask``: the steps that hold any visible (query, key) pair
of the block are exactly the ones it walks, under the causal mask, a
window, both, neither, and ragged T.  ``chip_smoke.BWD_EDGE_CALLS`` must
meet every float32 tile at T = tile - 1, tile and tile + 1, at d 64 and
128, causal without and with a window, and hold one call of more blocks
than one wave of the card.  ``bwd_ab.py`` imports neither JAX nor
``repro`` and needs a card.
"""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import cuda as fa_cuda
from repro_torch.kernels.flash_attention.ref import attention_mask

ROOT = pathlib.Path(__file__).resolve().parents[1]
H100_SMS = 132
BLOCKS_AN_SM = 3      # the most float32 backward blocks an SM holds


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


# (rows a block, rows a step) of every built backward tiling
TILINGS = sorted({(fa_cuda.BWD_ROWS[dt], step)
                  for dt, steps in fa_cuda.BWD_STEP.items()
                  for step in steps.values()})
LENGTHS = [(31, 31), (32, 32), (33, 33), (64, 64), (65, 65), (100, 100),
           (257, 257), (70, 45), (45, 70), (90, 33)]
WINDOWS = (0, 16, 40)


def _steps_seen(mask, rows, step, by_key: bool):
    """For each block of ``rows`` keys (``by_key``) or query rows, the
    steps of ``step`` rows of the other side that hold a visible pair."""
    m = mask if by_key else mask.T          # [other side, own side]
    n_own = m.shape[1]
    out = []
    for r0 in range(0, n_own, rows):
        other = m[:, r0:r0 + rows].any(dim=1).nonzero().flatten()
        out.append(sorted({int(i) // step for i in other}))
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Tq,Tk", LENGTHS)
def test_query_steps_of_a_key_block_match_the_mask(Tq, Tk, causal):
    """A dK / dV block walks exactly the query steps in which some query
    sees one of its keys, at every tiling and window."""
    for window in WINDOWS:
        mask = attention_mask(Tq, Tk, causal, window, Tk, 0,
                              "cpu").expand(Tq, Tk)
        for rows, step in TILINGS:
            want = _steps_seen(mask, rows, step, by_key=True)
            got = [list(fa_cuda.bwd_query_steps(k0, rows, step, Tq, Tk,
                                                causal, window))
                   for k0 in range(0, Tk, rows)]
            assert got == want, (window, rows, step)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Tq,Tk", LENGTHS)
def test_key_steps_of_a_query_block_match_the_mask(Tq, Tk, causal):
    """A dQ block walks exactly the key steps in which one of its rows
    sees some key, at every tiling and window."""
    for window in WINDOWS:
        mask = attention_mask(Tq, Tk, causal, window, Tk, 0,
                              "cpu").expand(Tq, Tk)
        for rows, step in TILINGS:
            want = _steps_seen(mask, rows, step, by_key=False)
            got = [list(fa_cuda.bwd_key_steps(q0, rows, step, Tq, Tk,
                                              causal, window))
                   for q0 in range(0, Tq, rows)]
            assert got == want, (window, rows, step)


def test_float32_tiles_are_the_kernels():
    """The float32 tiles chip_smoke names are the ones cuda.py mirrors
    from ``attn_bwd_f32.cuh``: 32 rows a block, 64 a step at d 64 and 32
    at d 128."""
    chip_smoke = _chip_smoke()
    f32 = torch.float32
    assert fa_cuda.BWD_ROWS[f32] == 32
    assert fa_cuda.BWD_STEP[f32] == {64: 64, 128: 32}
    assert set(chip_smoke.BWD_F32_TILES) == {
        fa_cuda.BWD_ROWS[f32], *fa_cuda.BWD_STEP[f32].values()}
    assert set(fa_cuda.BWD_STEP[f32]) == set(fa_cuda.BWD_HEAD_DIMS)


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("d", fa_cuda.BWD_HEAD_DIMS)
@pytest.mark.parametrize("tile", sorted({
    fa_cuda.BWD_ROWS[torch.float32],
    *fa_cuda.BWD_STEP[torch.float32].values()}))
def test_edge_calls_meet_every_float32_tile(tile, d, windowed):
    """T = tile - 1, tile, tile + 1 at each head dim, causal, with and
    without a window that masks inside the tile."""
    calls = _chip_smoke().BWD_EDGE_CALLS
    for t in (tile - 1, tile, tile + 1):
        hits = [c for c in calls
                if c[1] == c[2] == t and c[3] == d and c[4]
                and (0 < c[5] < t if windowed else c[5] == 0)]
        assert hits, (t, d, windowed)


def test_an_edge_call_has_more_blocks_than_one_wave():
    calls = _chip_smoke().BWD_EDGE_CALLS
    rows = fa_cuda.BWD_ROWS[torch.float32]
    assert max(BH * -(-max(Tq, Tk) // rows)
               for BH, Tq, Tk, *_ in calls) > H100_SMS * BLOCKS_AN_SM


def test_edge_calls_run_on_the_plain_versions():
    """Every edge call through ``bwd_edge_checks`` on the CPU: the plain
    versions against themselves, and the refused calls."""
    err = _chip_smoke().bwd_edge_checks("cpu",
                                        torch.Generator().manual_seed(0))
    assert err == 0.0


@pytest.mark.parametrize("causal,window,pairs", [
    (False, 0, 40 * 50),           # every pair
    (True, 0, 40 * 41 // 2),       # query i sees keys 0..i
    (False, 8, 8 * 50 + sum(57 - i for i in range(8, 40)))])  # i - 7..49
def test_backward_work_counts_every_visible_pair(causal, window, pairs):
    """``chip_smoke.serve_work`` counts the backward's five products over
    every visible pair of a [40, 50] call."""
    chip_smoke = _chip_smoke()
    BH, Tq, Tk, d = 2, 40, 50, 64
    q = torch.zeros(BH, Tq, d)
    k = torch.zeros(BH, Tk, d)
    a = dict(q=q, k=k, v=k, o=q, do=q, lse=torch.zeros(BH, Tq),
             scale=0.125, causal=causal, window=window, kv_len=Tk,
             q_offset=0)
    _, flops = chip_smoke.serve_work(chip_smoke.BWD, a)
    assert flops == 10 * BH * pairs * d


def test_bwd_ab_imports_no_jax_and_no_reference_package():
    tree = ast.parse((ROOT / "bwd_ab.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert "chip_smoke" in names and "torch" in names
    assert [n for n in names
            if n.split(".")[0] in ("jax", "jaxlib", "repro")] == []


def test_bwd_ab_refuses_to_run_without_a_card():
    """Without a card (or a tree to time) it exits non-zero and prints no
    result."""
    args = [] if torch.cuda.is_available() else ["src"]
    res = subprocess.run([sys.executable, str(ROOT / "bwd_ab.py"), *args],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert res.stdout == ""

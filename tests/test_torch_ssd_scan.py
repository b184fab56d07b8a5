"""The port's SSD scan (plain K8, ``ops.ssd`` and ``ssd_decode_step``)
against ``repro``'s on seeded numpy inputs.

The plain chunked version matches ``repro``'s ``ssd_scan_h`` in Pallas
interpret mode at ``tests/test_kernel_ssd.py``'s tolerances (1e-4 in
float32, 3e-2 in bf16); ``ops.ssd`` with grouped B / C and a T that is not a
multiple of the chunk matches ``repro``'s ``ops.ssd`` on the
``pallas_interpret`` backend; the decode step matches ``repro``'s.  At
chunk 128 with dt around 0.8, where ``repro``'s ``ssd_chunked_ref``
overflows to NaN (ROADMAP Queue 3), the port's chunked version is finite
and equals the per-step recurrence.  On the CPU the kernel's wrapper takes
the plain version; the CUDA kernel itself is held against it on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import use_backend
from repro.kernels.ssd_scan import ssd as ref_ssd
from repro.kernels.ssd_scan import ssd_chunked_ref as ref_chunked
from repro.kernels.ssd_scan import ssd_decode_step as ref_decode_step
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_h
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.ssd_scan import (
    ssd,
    ssd_chunked_ref,
    ssd_decode_step,
    ssd_ref,
    ssd_scan_ref,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def head_inputs(rng, H, T, P, N, realistic=False):
    """x [H, T, P], dt [H, T], A [H], B / C [H, T, N] in float32; dt and A
    as ``tests/test_kernel_ssd.py`` draws them or, ``realistic``, as the
    models' initialisation gives them: dt the softplus of a unit normal
    (mean about 0.8) and A = -exp(0) = -1."""
    x = rng.normal(size=(H, T, P)).astype(np.float32)
    if realistic:
        dt = np.log1p(np.exp(rng.normal(size=(H, T)))).astype(np.float32)
        A = -np.ones(H, np.float32)
    else:
        dt = (0.01 + 0.2 * rng.random(size=(H, T))).astype(np.float32)
        A = (-0.5 - rng.random(H)).astype(np.float32)
    B = rng.normal(size=(H, T, N)).astype(np.float32)
    C = rng.normal(size=(H, T, N)).astype(np.float32)
    return x, dt, A, B, C


def t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("H,T,P,N,chunk", [
    (2, 32, 8, 8, 8),
    (4, 64, 16, 8, 16),
    (3, 128, 32, 16, 32),
    (2, 96, 16, 16, 96),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_chunked_matches_pallas_interpret(H, T, P, N, chunk, dtype):
    x, dt, A, B, C = head_inputs(np.random.default_rng(1), H, T, P, N)
    jx = jnp.asarray(x).astype(dtype)
    want = ssd_scan_h(jx, *map(jnp.asarray, (dt, A, B, C)), chunk=chunk,
                      interpret=True)
    tx = t(x).to(getattr(torch, dtype))
    got = ssd_chunked_ref(tx, t(dt), t(A), t(B), t(C), chunk=chunk)
    assert got.dtype == tx.dtype
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    # the per-step recurrence, in float32 from the same inputs
    want_ref = ssd_ref(tx.float(), t(dt), t(A), t(B), t(C))
    np.testing.assert_allclose(got.float().numpy(), want_ref.numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("Bt,T,H,G,chunk", [
    (2, 37, 4, 2, 8),       # ragged last chunk, two groups
    (1, 20, 6, 3, 128),     # T below the chunk
    (2, 1, 4, 1, 128),      # one step
])
def test_ops_ssd_matches_reference_op(Bt, T, H, G, chunk):
    rng = np.random.default_rng(2)
    P, N = 8, 8
    x = rng.normal(size=(Bt, T, H, P)).astype(np.float32)
    dt = (0.01 + 0.5 * rng.random((Bt, T, H))).astype(np.float32)
    A = (-1.0 - rng.random(H)).astype(np.float32)
    B = rng.normal(size=(Bt, T, G, N)).astype(np.float32)
    C = rng.normal(size=(Bt, T, G, N)).astype(np.float32)
    with use_backend("pallas_interpret"):
        want = ref_ssd(*map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk)
    before = dict(LAUNCHES)
    got = ssd(*map(t, (x, dt, A, B, C)), chunk=chunk)
    assert LAUNCHES == before            # CPU tensors: the plain version
    assert got.shape == (Bt, T, H, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        ssd_scan_ref(*map(t, (x, dt, A, B, C)), chunk=chunk).numpy(),
        got.numpy(), rtol=0, atol=0)


def test_ops_ssd_rejects_malformed_input():
    x = torch.zeros(1, 4, 6, 8)
    dt = torch.zeros(1, 4, 6)
    A = torch.zeros(6)
    with pytest.raises(ValueError):
        ssd(x, dt, A, torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 8))
    with pytest.raises(ValueError):
        ssd(x, dt[..., :5], A, torch.zeros(1, 4, 2, 8),
            torch.zeros(1, 4, 2, 8))


def test_decode_step_matches_reference():
    rng = np.random.default_rng(3)
    Bt, H, G, N, P = 2, 4, 2, 8, 16
    S = rng.normal(size=(Bt, H, N, P)).astype(np.float32)
    x = rng.normal(size=(Bt, H, P)).astype(np.float32)
    dt = (0.01 + rng.random((Bt, H))).astype(np.float32)
    A = (-0.5 - rng.random(H)).astype(np.float32)
    B = rng.normal(size=(Bt, G, N)).astype(np.float32)
    C = rng.normal(size=(Bt, G, N)).astype(np.float32)
    want_S, want_y = ref_decode_step(*map(jnp.asarray, (S, x, dt, A, B, C)))
    got_S, got_y = ssd_decode_step(*map(t, (S, x, dt, A, B, C)))
    np.testing.assert_allclose(got_S.numpy(), np.asarray(want_S), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)


def test_chunked_finite_at_chunk_128_with_realistic_dt():
    """dt around 0.8 over a chunk of 128: the masked-out exponents
    l_t - l_s (s > t) pass 88.  ``repro``'s chunked oracle exponentiates
    them before masking and returns NaN; the port's masks first."""
    x, dt, A, B, C = head_inputs(np.random.default_rng(4), H=2, T=256, P=16,
                                 N=16, realistic=True)
    assert 0.7 < float(dt.mean()) < 0.9
    assert np.isnan(np.asarray(ref_chunked(
        *map(jnp.asarray, (x, dt, A, B, C)), chunk=128))).any()
    got = ssd_chunked_ref(*map(t, (x, dt, A, B, C)), chunk=128)
    assert bool(torch.isfinite(got).all())
    want = ssd_ref(*map(t, (x, dt, A, B, C)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    want = ssd_scan_h(*map(jnp.asarray, (x, dt, A, B, C)), chunk=128,
                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)

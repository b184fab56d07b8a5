"""Host substrate parity: the port's CSR problem, coarsening and host AMG
solver against ``repro``'s on the same inputs.

The port copies the reference's numpy arithmetic, so operators and C/F
splittings must be identical, and residual histories equal to 1e-12.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.amg import hierarchy as ref_hierarchy
from repro.amg import stencil as ref_stencil
from repro_torch.amg import hierarchy as port_hierarchy
from repro_torch.amg import stencil as port_stencil

PROBLEMS = {
    "paper_problem(4096)": lambda m: m.paper_problem(4096),
    "diffusion_2d(32,64)": lambda m: m.diffusion_2d(32, 64),
}


def _assert_csr_equal(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def hierarchies(request):
    make = PROBLEMS[request.param]
    A_ref, A_port = make(ref_stencil), make(port_stencil)
    return (A_ref, A_port, ref_hierarchy.build_hierarchy(A_ref),
            port_hierarchy.build_hierarchy(A_port))


def test_problem_operators_identical(hierarchies):
    A_ref, A_port, _, _ = hierarchies
    _assert_csr_equal(A_port, A_ref)


def test_splittings_and_operators_identical(hierarchies):
    _, _, h_ref, h_port = hierarchies
    assert h_port.n_levels == h_ref.n_levels
    for lr, lp in zip(h_ref.levels, h_port.levels):
        _assert_csr_equal(lp.A, lr.A)
        assert (lp.P is None) == (lr.P is None)
        if lr.P is not None:
            _assert_csr_equal(lp.P, lr.P)
            _assert_csr_equal(lp.R, lr.R)
            np.testing.assert_array_equal(lp.splitting, lr.splitting)
        assert lp.rho == lr.rho


def test_host_residual_histories_match(hierarchies):
    A_ref, _, h_ref, h_port = hierarchies
    b = np.random.default_rng(0).normal(size=A_ref.nrows)
    x_ref, hist_ref = ref_hierarchy.solve(h_ref, b, tol=1e-8, max_iters=40)
    x_port, hist_port = port_hierarchy.solve(h_port, b, tol=1e-8,
                                             max_iters=40)
    assert len(hist_port) == len(hist_ref)
    np.testing.assert_allclose(hist_port, hist_ref, rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(x_port, x_ref, rtol=1e-12, atol=1e-12)


def test_from_reference_hierarchy_rebuilds_the_same_hierarchy(hierarchies):
    A_ref, _, h_ref, h_port = hierarchies

    def op(m):
        return None if m is None else (m.indptr, m.indices, m.data, m.shape)

    h = port_hierarchy.from_reference_hierarchy(
        [(op(l.A), op(l.P), op(l.R), l.rho) for l in h_ref.levels]
    )
    assert h.n_levels == h_port.n_levels
    for got, want in zip(h.levels, h_port.levels):
        _assert_csr_equal(got.A, want.A)
        if want.P is not None:
            _assert_csr_equal(got.P, want.P)
            _assert_csr_equal(got.R, want.R)
        assert got.rho == want.rho
    b = np.random.default_rng(1).normal(size=A_ref.nrows)
    _, hist_ref = ref_hierarchy.solve(h_ref, b, tol=1e-8, max_iters=40)
    _, hist = port_hierarchy.solve(h, b, tol=1e-8, max_iters=40)
    np.testing.assert_allclose(hist, hist_ref, rtol=1e-12, atol=0.0)

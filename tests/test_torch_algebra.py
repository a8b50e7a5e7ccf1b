"""csmpn_torch.algebra against the Cayley fixtures and csmpn_tpu.algebra.

Tolerances: tables are compared exactly; tensor results in fp32 with
rtol 2e-4 / atol 1e-5, the reference package's own parity tolerance."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from csmpn_tpu.algebra import CliffordAlgebra as JAlgebra
from csmpn_torch.algebra import CliffordAlgebra, get_algebra
from csmpn_torch.nn.modules import CEMLP, init_parameters

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
METRICS = [((1.0, 1.0), "cl2"), ((1.0, 1.0, 1.0), "cl3"), ((1.0,) * 5, "cl5")]
RTOL, ATOL = 2e-4, 1e-5


@pytest.mark.parametrize("metric,tag", METRICS)
def test_cayley_matches_fixture_and_reference(metric, tag):
    z = np.load(os.path.join(FIXDIR, f"cayley_{tag}.npz"))
    alg = CliffordAlgebra(metric)
    np.testing.assert_array_equal(alg.cayley, z["cayley"])
    ref = JAlgebra(metric)
    np.testing.assert_array_equal(alg.cayley, ref.cayley)
    np.testing.assert_array_equal(alg.blade_to_grade, ref.blade_to_grade)
    np.testing.assert_array_equal(alg.geometric_product_paths,
                                  ref.geometric_product_paths)
    for a, b in zip(alg.gp_pair_tables, ref.gp_pair_tables):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(alg._b_coeff, ref._b_coeff)


@pytest.mark.parametrize("metric,tag", METRICS)
def test_grade_ops_and_norms_match_reference(metric, tag):
    alg, ref = CliffordAlgebra(metric), JAlgebra(metric)
    rng = np.random.RandomState(0)
    x = rng.randn(6, 3, alg.n_blades).astype(np.float32)
    y = rng.randn(6, 3, alg.n_blades).astype(np.float32)
    tx, ty, jx, jy = (torch.from_numpy(x), torch.from_numpy(y),
                      jnp.asarray(x), jnp.asarray(y))
    pairs = [
        (alg.geometric_product(tx, ty), ref.geometric_product(jx, jy)),
        (alg.q(tx), ref.q(jx)),
        (alg.norm(tx), ref.norm(jx)),
        (alg.qs_cat(tx), ref.qs_cat(jx)),
        (alg.norms_cat(tx), ref.norms_cat(jx)),
        (alg.alpha(tx), ref.alpha(jx)),
        (alg.beta(tx), ref.beta(jx)),
        (alg.gamma(tx), ref.gamma(jx)),
        (alg.embed_grade(tx[..., :alg.dim], 1),
         ref.embed_grade(jx[..., :alg.dim], 1)),
        (alg.expand_per_grade(tx[..., :alg.dim + 1]),
         ref.expand_per_grade(jx[..., :alg.dim + 1])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def test_versor_inverse_and_rho_are_isometries():
    alg = get_algebra((1.0, 1.0, 1.0))
    w = alg.versor(torch.Generator().manual_seed(1))
    one = alg.geometric_product(w, alg.inverse(w))
    expect = torch.zeros(8)
    expect[0] = 1.0
    np.testing.assert_allclose(one.numpy(), expect.numpy(), atol=1e-5)
    x = torch.randn(5, 8, generator=torch.Generator().manual_seed(2))
    np.testing.assert_allclose(alg.norm(alg.rho(w, x)).numpy(),
                               alg.norm(x).numpy(), rtol=1e-4, atol=1e-5)


def test_cemlp_rotor_equivariance():
    """CEMLP(rho(w, x)) == rho(w, CEMLP(x)) for a random rotor w."""
    alg = get_algebra((1.0, 1.0, 1.0))
    gen = torch.Generator().manual_seed(0)
    m = CEMLP(alg, 3, 5, 4, n_layers=2)
    init_parameters(m, gen)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    x = torch.randn(7, 3, 8, generator=gen)
    w = alg.versor(gen)
    with torch.no_grad():
        lhs = m(alg.rho(w, x))
        rhs = alg.rho(w, m(x))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-3,
                               atol=1e-4)

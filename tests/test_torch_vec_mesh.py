"""PyTorch port, the last public names of the JAX package's host and
vector helpers: ``geometry/mesh.py::torus_knot`` (NumPy) bit for bit at
its defaults and at a small size, and ``core/vec.py``'s ``norm2``,
``scale`` and ``vec3`` against the JAX package's, op by op (no jit, so
XLA fuses nothing and the float results are bitwise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.core import vec as jvec
from particlesystemhybridcollisiondetection_tpu.geometry import mesh as jmesh
from particlesystemhybridcollisiondetection_tpu_torch.core import vec as tvec
from particlesystemhybridcollisiondetection_tpu_torch.geometry import mesh as tmesh


@pytest.mark.parametrize("kw", [{}, dict(p=3, q=5, tube_radius=0.2,
                                         knot_radius=2.5, segments=16,
                                         tube_segments=6)])
def test_torus_knot_bitwise(kw):
    a, b = tmesh.torus_knot(**kw), jmesh.torus_knot(**kw)
    assert a.name == b.name == "torus_knot"
    for got, want in ((a.vertices, b.vertices), (a.faces, b.faces)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert a.num_triangles == 2 * kw.get("segments", 512) * kw.get("tube_segments", 64)


def test_vec_norm2_scale_vec3_bitwise():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(3, 64, 5)).astype(np.float32)
    s = rng.uniform(-2, 2, size=(64, 5)).astype(np.float32)
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    jv, js = jnp.asarray(v), jnp.asarray(s)
    np.testing.assert_array_equal(tvec.norm2(tv).numpy(), np.asarray(jvec.norm2(jv)))
    np.testing.assert_array_equal(tvec.scale(tv, ts).numpy(),
                                  np.asarray(jvec.scale(jv, js)))
    got, want = tvec.vec3(0.1, -2.0, 3), jvec.vec3(0.1, -2.0, 3)
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tvec.vec3(1, 2, 3, dtype=torch.int32).numpy(),
        np.asarray(jvec.vec3(1, 2, 3, dtype=jnp.int32)))

"""Degenerate triangles: the gradients of ``soup_normal_consistency`` and of
the shading normals (``shade_soup``) at triangles with a zero-length edge,
the port against the JAX package, on the CPU.

Both normalise the face normal through a clamped squared norm
(``safe_normalize``); neither reaches ``linalg.norm``'s gradient at 0 (NaN
in JAX, 0 in torch). Where the cross product is exactly 0 (three equal
corners) the normal is 0 and its gradient 1 / eps = 1e9 times the incoming
one in both. Where two corners coincide, the fused multiply-adds of the
cross product leave a residue of ~3e-8 (the same in both packages), whose
direction becomes the normal: its value agrees, its gradient is that
residue's, amplified ~3e7 times, and the two packages' gradients part
there by ~2% of their largest entry (ill-conditioned, not a fault of
either).

Two soups: one built by hand, and one from ``marching_tets`` with the SDF
exactly 0 at a grid vertex, where two crossings of the same tet land on
that vertex. There the crossing's t sits at the clip's bound 0, where
``jnp.clip`` (a maximum and a minimum) passes half the gradient; the port
copies it (``torch.clamp`` would pass all of it). The values within 1e-6 of the largest, every gradient finite
and equal in which entries are zero; the hand-built soup's gradient within
1e-6 of its largest entry; at the marching-tets soup the loss weights the
triangles with a zero-length edge by 0 for the comparison of the
gradients (within 1e-5 of the largest: float32 through the crossings, the
cross products, the normalisation and the shading), and with them
weighted in both gradients stay finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.nerf import dmtet as JD
from dreamwaltz_g_tpu.nerf import isosurface as JI
from dreamwaltz_g_tpu_torch.nerf import dmtet as TD
from dreamwaltz_g_tpu_torch.nerf import isosurface as TI
import tests.torch_threads  # noqa: F401  (per-worker threads)

LIGHT = np.asarray([0.3, 0.8, 0.52], np.float32)


def _losses(D, soup, albedo, light, xp, keep=None):
    """The normal consistency and a weighted sum of the shading; ``keep``
    (M,) masks triangles out of both."""
    shaded = D.shade_soup(soup, albedo, "lambertian", light,
                          ambient_ratio=0.2)
    n = shaded.shape[0] * shaded.shape[1]
    w = xp.arange(1, n + 1, dtype=xp.float32).reshape(shaded.shape)
    if keep is not None:
        w = w * keep[:, None]
        soup = soup._replace(valid=soup.valid & (keep > 0))
    return D.soup_normal_consistency(soup) + xp.sum(shaded * w) * 1e-3


def _close(name, got, want, rel=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(want).all() and np.isfinite(got).all(), name
    np.testing.assert_array_equal(got == 0, want == 0, err_msg=name)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (
        name, float(np.abs(got - want).max()), scale)


def _hand_soup():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(6, 3, 3)).astype(np.float32)
    v[0, 2] = v[0, 1]                 # a zero-length edge, paired with v[1]
    v[2, 0] = v[2, 1] = v[2, 2]       # all three corners at one point
    v[5] = v[4]                       # a pair of equal triangles
    valid = np.asarray([True, True, True, True, True, True])
    return v, valid


def test_hand_built_degenerate_soup_gradients_match_jax():
    v, valid = _hand_soup()
    albedo = np.random.default_rng(1).uniform(size=(6, 3)).astype(np.float32)

    def jloss(verts):
        return _losses(JD, JI.TriangleSoup(verts, jnp.asarray(valid)),
                       jnp.asarray(albedo), jnp.asarray(LIGHT), jnp)

    jval, jg = jax.value_and_grad(jloss)(jnp.asarray(v))
    tv = torch.as_tensor(v).requires_grad_(True)
    tval = _losses(TD, TI.TriangleSoup(tv, torch.as_tensor(valid)),
                   torch.as_tensor(albedo), torch.as_tensor(LIGHT), torch)
    tval.backward()
    _close("value", tval.detach(), jval)
    _close("d/dvertices", tv.grad, jg)
    # three equal corners: the cross product and the normal are exactly 0,
    # and so is the gradient reaching the corners (1e9 x a zero Jacobian)
    n = TD.soup_face_normals(TI.TriangleSoup(tv.detach(),
                                             torch.as_tensor(valid)))
    assert not n[2].any() and not tv.grad[2].any()


@pytest.mark.parametrize("vertex", [0, 5])
def test_marching_tets_with_a_zero_sdf_vertex_gradients_match_jax(vertex):
    rng = np.random.default_rng(2)
    verts = rng.normal(size=(8, 3)).astype(np.float32)
    tets = np.asarray([[0, 1, 2, 3], [0, 2, 3, 4], [2, 3, 4, 5],
                       [4, 5, 6, 7], [1, 3, 5, 7]], np.int32)
    sdf = np.asarray([0.4, -0.3, 0.2, -0.5, 0.6, -0.2, 0.3, -0.4],
                     np.float32)
    sdf[vertex] = 0.0                 # crossings land on the vertex
    albedo = rng.uniform(size=(10, 3)).astype(np.float32)

    def zero_edge(tri):
        """(M,) 1.0 where the triangle has no zero-length edge."""
        e = [tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 1],
             tri[:, 0] - tri[:, 2]]
        return 1.0 - np.any([np.abs(x).sum(-1) == 0 for x in e],
                            axis=0).astype(np.float32)

    def jloss(vv, s, keep):
        soup = JI.marching_tets(vv, s, jnp.asarray(tets))
        return _losses(JD, soup, jnp.asarray(albedo), jnp.asarray(LIGHT),
                       jnp, keep), soup

    def tloss(keep):
        tv = torch.as_tensor(verts).requires_grad_(True)
        ts = torch.as_tensor(sdf).requires_grad_(True)
        soup = TI.marching_tets(tv, ts, torch.as_tensor(tets,
                                                        dtype=torch.long))
        val = _losses(TD, soup, torch.as_tensor(albedo),
                      torch.as_tensor(LIGHT), torch,
                      None if keep is None else torch.as_tensor(keep))
        val.backward()
        return val.detach(), soup, tv.grad, ts.grad

    grad = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)
    (jval, jsoup), (jgv, jgs) = grad(jnp.asarray(verts), jnp.asarray(sdf),
                                     None)
    tval, soup, tgv, tgs = tloss(None)
    np.testing.assert_array_equal(soup.valid.numpy(), np.asarray(jsoup.valid))
    _close("vertices", soup.vertices.detach(), jsoup.vertices)
    _close("value", tval, jval)
    keep = zero_edge(np.asarray(jsoup.vertices))
    assert (keep[np.asarray(jsoup.valid)] == 0).any()  # a valid one is in
    for g in (jgv, jgs, tgv, tgs):
        assert np.isfinite(np.asarray(g)).all()
    (jval, _), (jgv, jgs) = grad(jnp.asarray(verts), jnp.asarray(sdf),
                                 jnp.asarray(keep))
    tval, _, tgv, tgs = tloss(keep)
    _close("value without them", tval, jval)
    # float32 through the crossings' interpolation, the cross products,
    # the normalisation and the shading: 1e-5 of the largest
    _close("d/dverts without them", tgv, jgv, rel=1e-5)
    _close("d/dsdf without them", tgs, jgs, rel=1e-5)

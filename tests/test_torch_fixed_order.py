"""The trainer steps' fixed-order sums against the JAX package.

* ``ops/blend_train.py:panel_grads``, B1's panel sum (each (B, T, K, 16)
  panel entry into its Gaussian's row), against ``jax.vjp`` of the JAX
  package's per-tile gather ``attrs[tile_lists]``
  (``ops/pallas_blend.py:635``) view by view: seeded panels and lists with
  empty slots naming the sentinel row, and a row that sits in every tile
  of every view. Float32 sums of the same terms in another order: within
  1e-6 of each gradient's largest entry (and 1e-6 relative).
* The sum adds each row's entries in (tile, slot) order within its view:
  a row that takes 2^24, then sixteen 1s, then -2^24 sums to 0 in float32
  only in that order (the 1s are each lost to the rounding beside 2^24).
* ``nerf/dmtet.py:tet_laplacian_loss`` and its gradient against the JAX
  function on a random edge graph with a vertex of high degree and
  vertices without an edge: within 1e-6 relative (the neighbour sums are a
  gather and a sum over the table's padded axis, the JAX ones a
  scatter-add); ``edge_table`` lists each vertex's neighbours in the JAX
  scatter's order, and a table built once gives the loss and gradient of
  the raw edges to the bit.
* ``ops/mesh.py:sample_faces``, the sigma guidance's face draw (the
  inverse of a running sum taken on the host): 200,000 draws over seeded
  areas land on each face within 5 standard errors of its share of the
  area (the JAX package's ``jax.random.categorical`` of the log areas draws
  from the same distribution), a face of zero area never, and one
  generator state gives the same faces.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.nerf import dmtet as JD
from dreamwaltz_g_tpu_torch.nerf import dmtet as TD
from dreamwaltz_g_tpu_torch.ops import mesh as TM
from dreamwaltz_g_tpu_torch.ops import blend_train as BT
import tests.torch_threads  # noqa: F401  (per-worker threads)

CV = 5
TOL = 1e-6


def _lists(rng, B, T, K, N, empty, heavy):
    """(B, T, K) tile lists over rows 0..N-1 with a share ``empty`` of
    slots at the sentinel N; with ``heavy`` row 0 in every tile."""
    tl = rng.integers(0, N, size=(B, T, K))
    tl[rng.random((B, T, K)) < empty] = N
    if heavy:
        tl[:, :, rng.integers(0, K)] = 0
    return tl


def _jax_panel_grads(d_panels, tl, N):
    """The vjp of ``attrs[tile_lists]`` for each view: (B, N, 16)."""
    out = []
    for b in range(tl.shape[0]):
        _, vjp = jax.vjp(lambda a: a[jnp.asarray(tl[b])],
                         jnp.zeros((N + 1, 16), jnp.float32))
        out.append(np.asarray(vjp(jnp.asarray(d_panels[b]))[0])[:N])
    return np.stack(out)


@pytest.mark.parametrize("B,T,K,N,empty,heavy", [
    (1, 16, 64, 300, 0.3, False),
    (1, 16, 64, 300, 0.9, True),
    (3, 12, 48, 50, 0.2, True),
    (4, 8, 32, 1000, 0.0, False)])
def test_panel_sum_matches_jax_vjp(B, T, K, N, empty, heavy):
    rng = np.random.default_rng(B * 1000 + T + K + N)
    tl = _lists(rng, B, T, K, N, empty, heavy)
    d = rng.normal(size=(B, T, K, 16)).astype(np.float32)
    want = _jax_panel_grads(d, tl, N)
    got = BT.panel_grads(torch.as_tensor(d),
                         torch.as_tensor(tl, dtype=torch.int32), N + 1, CV)
    lanes = ((0, 2), (2, 5), (5, 6), (8, 8 + CV))
    for g, (lo, hi) in zip(got, lanes):
        g = g.numpy().reshape(B, N, -1)
        w = want[..., lo:hi]
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=TOL,
                                   atol=TOL * float(np.abs(w).max()))
    if heavy:
        assert float(np.abs(want[:, 0]).max()) > 0
    # the sentinel's entries reach no row
    untouched = np.setdiff1d(np.arange(N), tl[tl < N])
    assert not any(float(np.abs(g.numpy().reshape(B, N, -1)[:, untouched])
                         .max(initial=0.0)) for g in got)


def test_panel_sum_adds_in_tile_slot_order():
    B, T, K, N = 1, 6, 8, 10
    tl = np.full((B, T, K), N)
    d = np.zeros((B, T, K, 16), np.float32)
    # row 3 takes 2^24 first, then sixteen 1s over the tiles, then -2^24
    slots = [(b, t, k) for b in range(B) for t in range(T)
             for k in (1, 3, 5)]
    for i, (b, t, k) in enumerate(slots):
        tl[b, t, k] = 3
        d[b, t, k, :] = 2.0 ** 24 if i == 0 else (
            -(2.0 ** 24) if i == len(slots) - 1 else 1.0)
    assert len(slots) == 16 + 2
    got = BT.panel_grads(torch.as_tensor(d), torch.as_tensor(tl), N + 1, CV)
    assert all(float(g[:, 3].abs().sum()) == 0.0 for g in got)
    # the same terms summed small ones first give 16
    small_first = sorted(d[..., 0][tl == 3], key=abs)
    assert float(np.float32(sum(np.float32(x) for x in small_first))) == 16.0


def _graph(rng, V, E):
    """Unique undirected (E', 2) edges, first end below the second, in
    ``np.unique``'s order, with vertex 0 joined to every 3rd vertex and
    the last 5 vertices left without an edge."""
    a = rng.integers(0, V - 5, size=E)
    b = rng.integers(0, V - 5, size=E)
    e = np.stack([a, b], 1)
    hub = np.arange(1, V - 5, 3)
    e = np.concatenate([e, np.stack([np.zeros_like(hub), hub], 1)])
    e = e[e[:, 0] != e[:, 1]]
    return np.unique(np.sort(e, axis=1), axis=0)


@pytest.mark.parametrize("V,E", [(40, 60), (500, 2000)])
def test_tet_laplacian_matches_jax(V, E):
    rng = np.random.default_rng(V)
    edges = _graph(rng, V, E)
    verts = rng.normal(size=(V, 3)).astype(np.float32)
    jlap, jg = jax.value_and_grad(JD.tet_laplacian_loss)(
        jnp.asarray(verts), jnp.asarray(edges))
    v = torch.as_tensor(verts).requires_grad_(True)
    lap = TD.tet_laplacian_loss(v, torch.as_tensor(edges))
    lap.backward()
    assert float(jlap) > 0
    np.testing.assert_allclose(float(lap.detach()), float(jlap), rtol=TOL)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg), rtol=TOL,
                               atol=TOL * float(np.abs(np.asarray(jg)).max()))
    # vertices without an edge take no gradient
    assert not v.grad[-5:].any()


def test_edge_table_order_and_reuse():
    rng = np.random.default_rng(1)
    V = 60
    edges = _graph(rng, V, 150)
    table = TD.edge_table(edges, V)
    assert table.n_edges == edges.shape[0]
    nb, valid = table.neighbours.numpy(), table.valid.numpy()
    for v in range(V):
        # the JAX scatter's order: edges where v is the first end, then
        # those where it is the second, each in edge order
        want = list(edges[edges[:, 0] == v, 1]) \
            + list(edges[edges[:, 1] == v, 0])
        assert list(nb[v][valid[v]]) == want
        assert (nb[v][~valid[v]] == v).all()
        assert table.degree[v] == len(want)
    assert table.neighbours.shape[1] == int(table.degree.max())
    verts = torch.as_tensor(rng.normal(size=(V, 3)), dtype=torch.float32)
    runs = []
    for e in (table, torch.as_tensor(edges)):
        v = verts.clone().requires_grad_(True)
        loss = TD.tet_laplacian_loss(v, e)
        loss.backward()
        runs.append((loss.detach(), v.grad))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_sample_faces_draws_by_area():
    rng = np.random.default_rng(3)
    area = rng.uniform(0.0, 2.0, size=50).astype(np.float32)
    area[[4, 17]] = 0.0
    a = torch.clamp(torch.as_tensor(area), min=1e-20)
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    f = TM.sample_faces(a, n, gen).numpy()
    share = area / area.sum()
    counts = np.bincount(f, minlength=area.size)
    se = np.sqrt(n * share * (1 - share))
    assert np.all(np.abs(counts - n * share) <= 5 * se + 1e-9)
    assert counts[4] == counts[17] == 0
    gen.set_state(state)
    assert np.array_equal(TM.sample_faces(a, n, gen).numpy(), f)

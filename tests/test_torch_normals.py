"""The port's vertex normals, summed in a fixed order, against the JAX
package's ``.at[].add`` sums, on the CPU.

The three normals of the port (``system.avatar._vertex_normals``, area
weighted; ``ops.mesh.vertex_normals``, the mean of unit face normals;
``gaussian.seed._vertex_normals``, area weighted) all go through
``ops.mesh.sum_at_vertices``: a gather through ``corner_table`` and a sum
over the padded axis, with no atomics. Only the order of a float32 sum
differs from the JAX package's, so the normals agree within 1e-6 (a few
float32 roundings of unit vectors). Inputs are seeded numpy arrays handed
to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.gaussian import seed as JS
from dreamwaltz_g_tpu.ops import mesh as JM
from dreamwaltz_g_tpu.system import avatar as JA
from dreamwaltz_g_tpu_torch.gaussian import seed as TS
from dreamwaltz_g_tpu_torch.ops import mesh as TM
from dreamwaltz_g_tpu_torch.system import avatar as TA
import tests.torch_threads  # noqa: F401  (per-worker threads)

TOL = 1e-6


def _mesh(seed, n_vertices=40, n_faces=90):
    """Seeded vertices and faces of three distinct vertices each; two
    vertices that no face names (their normals are zero in both
    packages)."""
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(n_vertices, 3)).astype(np.float32)
    faces = np.stack([rng.choice(n_vertices - 2, 3, replace=False)
                      for _ in range(n_faces)]).astype(np.int64)
    return verts, faces


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["avatar", "mesh", "seed"])
def test_normals_match_jax(kind, seed):
    verts, faces = _mesh(seed)
    tv = torch.as_tensor(verts)
    if kind == "avatar":
        got = TA._vertex_normals(tv, faces,
                                 TM.corner_table(faces, len(verts)))
        want = JA._vertex_normals(jnp.asarray(verts), faces)
    elif kind == "mesh":
        got = TM.vertex_normals(tv, faces)
        want = JM.vertex_normals(jnp.asarray(verts), jnp.asarray(faces))
    else:
        got = TS._vertex_normals(tv, faces)
        want = JS._vertex_normals(jnp.asarray(verts), jnp.asarray(faces))
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == verts.shape
    assert float(np.abs(got - want).max()) <= TOL
    assert not got[-2:].any()


def test_corner_table_holds_each_corner_once_in_order():
    verts, faces = _mesh(3)
    V, F = len(verts), len(faces)
    table = TM.corner_table(faces, V)
    real = table[table < 3 * F]
    # each (face, corner) exactly once, at the vertex it names
    assert sorted(real.tolist()) == list(range(3 * F))
    rows = np.nonzero(table < 3 * F)[0]
    assert (faces.reshape(-1)[table[table < 3 * F]] == rows).all()
    # ascending along each row, the pad only at a row's end
    for row in table:
        n = int((row < 3 * F).sum())
        assert (np.diff(row[:n]) > 0).all() and (row[n:] == 3 * F).all()
    # the pad reads a zero row: ones sum to each vertex's corner count
    ones = torch.ones((F, 2))
    counts = TM.sum_at_vertices(ones, table)
    assert counts[:, 0].tolist() == np.bincount(
        faces.reshape(-1), minlength=V).astype(np.float32).tolist()
    assert table.shape == (V, int(np.bincount(faces.reshape(-1)).max()))


def test_part_keeps_its_table_and_the_cache_builds_once():
    """The avatar's part submesh carries its table from the model build;
    tables for other face arrays are built once and kept."""
    verts, faces = _mesh(4)
    V = int(faces.max()) + 1
    st = TA.make_mesh_binding_static(faces, np.arange(V),
                                     np.arange(len(faces)))
    np.testing.assert_array_equal(st.corners, TM.corner_table(faces, V))
    a = TM.cached_corner_table(faces, len(verts))
    b = TM.cached_corner_table(torch.as_tensor(faces), len(verts))
    assert a is b


@pytest.mark.parametrize("kind", ["avatar", "mesh", "seed"])
def test_two_calls_equal_to_the_bit(kind):
    verts, faces = _mesh(5, n_vertices=300, n_faces=900)
    tv = torch.as_tensor(verts)
    fn = {"avatar": lambda: TA._vertex_normals(tv, faces),
          "mesh": lambda: TM.vertex_normals(tv, faces),
          "seed": lambda: TS._vertex_normals(tv, faces)}[kind]
    a, b = fn(), fn()
    assert torch.equal(a, b)

"""The float32 flash kernels' arithmetic, on the CPU: three-pass TF32.

On the card the float32 kernels form each product on the tensor cores from
TF32 pieces of its operands, hi = tf32(x) and lo = tf32(x - hi), as
lo·hi + hi·lo + hi·hi. Their plain twins (``flash.tf32_round``,
``flash_attention_tf32_plain``, ``flash_attention_tf32_plain_bwd``) repeat
those products here, held to the float32 plain versions and to the JAX
package's Pallas kernel (the Mosaic interpreter, as
``tests/test_torch_flash.py`` runs it) within the unchanged float32
tolerances: 1e-5 absolute on the output, 1e-4 of each gradient's largest
entry. A single TF32 product (10 mantissa bits) misses them, so the
tolerances tell the two designs apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dreamwaltz_g_tpu.guidance import layers as JL
from dreamwaltz_g_tpu_torch.guidance import flash as FL
import tests.torch_threads  # noqa: F401  (per-worker threads)

TOL_OUT = 1e-5
TOL_GRAD = 1e-4
HEAD_DIMS = [16, 40, 64, 512]


def _shape(D):
    return (1, 256, 2, D) if D <= 128 else (1, 128, 1, D)


def _qkvg(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _bits(x):
    return torch.as_tensor(np.asarray(x, np.float32)).view(torch.int32)


def test_tf32_round_keeps_ten_mantissa_bits():
    """Every result has its 13 low mantissa bits clear and lies within half
    a TF32 step, 2^-11 |x|, of x."""
    x = torch.as_tensor(_qkvg((4096,), 1)[0] * 1e3)
    r = FL.tf32_round(x)
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((r - x).abs() <= 2.0 ** -11 * x.abs()).all())
    assert bool((r != x).any())


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_tf32_round_ties_away_from_zero(sign):
    """A value half-way between two TF32 neighbours goes to the larger
    magnitude; just below half-way it goes to the smaller."""
    tie = sign * (1 + 2.0 ** -11)
    below = np.nextafter(np.float32(tie), np.float32(0))
    got = FL.tf32_round(torch.tensor([tie, below, sign * 3.0]))
    assert got.tolist() == [sign * (1 + 2.0 ** -10), sign * 1.0, sign * 3.0]
    assert int(_bits(tie)) & 0x1FFF == 0x1000


def test_tf32_split_reconstructs_within_2_to_the_minus_22():
    """hi + lo is x to within 2^-22 |x|, the three-pass products' error per
    operand; hi alone is within 2^-11."""
    x = torch.as_tensor(_qkvg((8192,), 2)[0])
    hi, lo = FL.tf32_split(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all())
    assert float(((hi - x).abs() / x.abs()).max()) > 2.0 ** -22


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_three_pass_plain_matches_plain_and_jax(D):
    """The three-pass forward and backward against the float32 plain
    versions and the interpreted TPU kernel: 1e-5 absolute on out (and
    lse), 1e-4 of each gradient's largest entry."""
    shape = _shape(D)
    q, k, v, g = _qkvg(shape, 100 + D)

    def loss(q, k, v):
        return (JL.flash_self_attention(q, k, v) * g).sum()

    with pltpu.force_tpu_interpret_mode():
        jout = JL.flash_self_attention(*map(jnp.asarray, (q, k, v)))
        jgrads = jax.grad(loss, argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tg = (torch.as_tensor(x) for x in (q, k, v, g))
    ref, ref_lse = FL.flash_attention_plain(tq, tk, tv)
    out, lse = FL.flash_attention_tf32_plain(tq, tk, tv)
    assert out.dtype == torch.float32 and out.shape == shape
    assert float((out - ref).abs().max()) <= TOL_OUT
    assert float((out - torch.as_tensor(np.array(jout))).abs().max()) \
        <= TOL_OUT
    assert float((lse - ref_lse).abs().max()) <= TOL_OUT
    grads = FL.flash_attention_tf32_plain_bwd(tq, tk, tv, out, lse, tg)
    refs = FL.flash_attention_plain_bwd(tq, tk, tv, ref, ref_lse, tg)
    for got, want, jwant in zip(grads, refs, jgrads):
        assert got.shape == shape
        assert _rel(got, want) <= TOL_GRAD
        assert _rel(got, torch.as_tensor(np.array(jwant))) <= TOL_GRAD


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_single_pass_tf32_misses_the_float32_tolerance(D):
    """One TF32 product (hi·hi) keeps 10 mantissa bits: on the same inputs
    its output misses 1e-5 and its gradients 1e-4 of their largest entry,
    while the three-pass products pass both (above)."""
    q, k, v, g = (torch.as_tensor(x) for x in _qkvg(_shape(D), 100 + D))
    ref, ref_lse = FL.flash_attention_plain(q, k, v)
    out, lse = FL.flash_attention_tf32_plain(q, k, v, passes=1)
    assert float((out - ref).abs().max()) > TOL_OUT
    grads = FL.flash_attention_tf32_plain_bwd(q, k, v, ref, ref_lse, g,
                                              passes=1)
    refs = FL.flash_attention_plain_bwd(q, k, v, ref, ref_lse, g)
    assert max(_rel(a, b) for a, b in zip(grads, refs)) > TOL_GRAD


def test_tf32_einsum_takes_one_or_three_passes():
    x = torch.ones((2, 2))
    with pytest.raises(ValueError, match="passes"):
        FL.flash_attention_tf32_plain(x[None, :, None], x[None, :, None],
                                      x[None, :, None], passes=2)

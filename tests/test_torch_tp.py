"""Tensor-parallel guidance (``parallel/tp.py``) against the JAX package, on
the CPU.

The port's ranks are ``gloo`` processes spawned with a join deadline and
one intra-op thread each (``tests/torch_ranks.py``); the JAX side runs in
this process on the conftest's virtual devices, under ``make_mesh_2d``
with ``shard_guidance_params``' Megatron layout.

* The shard rule against ``guidance_pspecs``, leaf for leaf, on the tiny
  UNet, ControlNet and VAE; and on the SD1.5, SD2.x and SDXL UNets' own
  parameter names (built without memory): the attention projections and
  the GEGLU feed-forward, nothing else.
* The UNet with the ControlNet's residuals at tp = 2 against the JAX eps
  prediction under ``make_mesh_2d(dp=1, tp=2)`` on the same converted
  weights, at the JAX tensor-parallel tests' rtol 2e-4 / atol 2e-5; each
  rank holds one of the tiny UNet's two heads a block.
* A UNet whose blocks have 3 heads at tp = 2: GSPMD reshards them, the
  port splits them 2 + 1; the same tolerance. A block with fewer heads
  than ranks raises (a difference by design: GSPMD runs it).
* The input gradient through a sharded transformer block (the column-
  parallel input's backward all-reduce) against the whole block's.

The (dp = 2, tp = 2) avatar step is ``test_torch_dp_tp.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dreamwaltz_g_tpu.guidance.unet import UNet2DCondition as JUNet
from dreamwaltz_g_tpu.guidance.unet import UNetConfig as JUNetConfig
from dreamwaltz_g_tpu.parallel.mesh import make_mesh_2d as jmesh_2d
from dreamwaltz_g_tpu.parallel.tp import guidance_pspecs as jpspecs
from dreamwaltz_g_tpu.parallel.tp import shard_guidance_params as jshard
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch.guidance import layers as L
from dreamwaltz_g_tpu_torch.guidance import unet as TU
from dreamwaltz_g_tpu_torch.guidance.sds import GuidanceParams
from dreamwaltz_g_tpu_torch.parallel import DataMesh
from dreamwaltz_g_tpu_torch.parallel import tp as TP
from tests import torch_ranks as TR
from tests.torch_jax_pairs import _seeded, tiny_guidance_pair
import tests.torch_threads  # noqa: F401  (per-worker threads)

# the JAX package's tensor-parallel forward tolerance (tests/test_tp.py)
RTOL, ATOL = 2e-4, 2e-5
LAT = 8
SPEC = {P(): None, P(None, "model"): TP.COLUMN, P("model", None): TP.ROW,
        P("model"): TP.COLUMN}


def _spec_names(tree):
    """{port parameter name: rule} of a JAX PartitionSpec tree."""
    tree = tree.get("params", tree)
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    out = {}
    for path, spec in leaves:
        *mods, kind = [k.key for k in path]
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[kind]
        out[f"{convert._module_path(mods)}.{leaf}"] = SPEC[spec]
    return out


def test_shard_rule_matches_guidance_pspecs():
    _, jgp, _, tgp = tiny_guidance_pair(LAT, with_controlnet=True)
    want, got = jpspecs(jgp), TP.guidance_pspecs(tgp)
    for model in ("unet", "controlnet"):
        assert _spec_names(getattr(want, model)) == got[model], model
    # the VAE replicated (its Flax tree nests the encoder's and decoder's)
    vae = jax.tree_util.tree_leaves(want.vae,
                                    is_leaf=lambda x: isinstance(x, P))
    assert len(vae) == len(got["vae"]) > 0
    assert set(vae) == {P()} and set(got["vae"].values()) == {None}
    rules = list(got["unet"].values()) + list(got["controlnet"].values())
    assert rules.count(TP.COLUMN) > 0 and rules.count(TP.ROW) > 0


@pytest.mark.parametrize("config", ["sd15", "sd21", "sdxl"])
def test_shard_rule_on_the_cards(config):
    """Each attention projection and GEGLU layer of the card's UNet takes
    the rule, every other parameter is replicated."""
    cfg = getattr(TU, f"{config}_unet_config")()
    with torch.device("meta"):
        unet = TU.UNet2DCondition(cfg)
    want = {}
    for name, m in unet.named_modules():
        if isinstance(m, L.Attention):
            want.update({f"{name}.to_{k}.weight": TP.COLUMN
                         for k in "qkv"})
            want[f"{name}.to_out.0.weight"] = TP.ROW
        elif isinstance(m, L.FeedForwardGEGLU):
            want[f"{name}.net.0.proj.weight"] = TP.COLUMN
            want[f"{name}.net.0.proj.bias"] = TP.COLUMN
            want[f"{name}.net.2.weight"] = TP.ROW
    got = {n: r for n, r in TP.guidance_pspecs(
        GuidanceParams(unet=unet, vae=torch.nn.Linear(1, 1)))["unet"].items()
        if r is not None}
    assert got == want and len(want) > 100


def _inputs(D, cond=True, seed=2):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = dict(lat=rng.normal(size=(2, LAT, LAT, 4)).astype(f32),
             t=np.array([300, 701], np.int32),
             ctx=rng.normal(size=(2, 4, D)).astype(f32))
    x["cond"] = rng.uniform(size=(2, 2 * LAT, 2 * LAT, 3)).astype(f32) \
        if cond else None
    return x


def _jax_eps(jsd, jgp, x, tp=2):
    mesh = jmesh_2d(dp=1, tp=tp)
    args = [None if v is None else jnp.asarray(v) for v in x.values()]
    with mesh:
        out = jax.jit(lambda p, *a: jsd._eps(p, *a))(
            jshard(jgp, mesh), *args)
    return np.asarray(out)


def _port_eps(tmp_path, tsd, tgp, x, world=2):
    path = TR.save(tmp_path / "eps.pt", dict(
        sd=tsd, gp=tgp, **{k: None if v is None else torch.as_tensor(v)
                           for k, v in x.items()}))
    return TR.run_ranks(TR.tp_eps, world, path)


def test_unet_and_controlnet_at_tp2_match_jax(tmp_path):
    jsd, jgp, tsd, tgp = tiny_guidance_pair(LAT, with_controlnet=True)
    x = _inputs(32)
    want = _jax_eps(jsd, jgp, x)
    ranks = _port_eps(tmp_path, tsd, tgp, x)
    for r in ranks:
        assert r["heads"] == [1]        # the tiny UNet's 2 heads over 2
        np.testing.assert_allclose(r["eps"], want, rtol=RTOL, atol=ATOL)
    # the ControlNet reaches the prediction
    no_cn = _jax_eps(dataclasses.replace(jsd, controlnet=None), jgp, x)
    assert np.abs(no_cn - want).max() > 100 * ATOL


def _three_head_pair():
    """A tiny UNet whose attention blocks have 3 heads of 32 (seeded
    weights), in both packages."""
    kw = dict(block_out_channels=(96, 96), layers_per_block=1,
              cross_attention_dim=32, head_dim=32, attn_down=(True, False))
    jcfg, tcfg = JUNetConfig(**kw), TU.UNetConfig(**kw)
    assert tcfg.block_heads(96) == 3
    unet = JUNet(jcfg)
    key = jax.random.PRNGKey(0)
    tree = _seeded(jax.eval_shape(
        unet.init, key, jnp.zeros((1, LAT, LAT, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 4, 32))),
        np.random.default_rng(5))
    tunet = L.build(lambda: TU.UNet2DCondition(tcfg), "cpu")
    convert.unet_from_flax(tunet, tree)
    return unet, jax.tree_util.tree_map(jnp.asarray, tree), tunet


def test_heads_tp_does_not_divide_match_jax(tmp_path):
    jsd, jgp, tsd, tgp = tiny_guidance_pair(LAT)
    unet, params, tunet = _three_head_pair()
    jsd = dataclasses.replace(jsd, unet=unet, controlnet=None)
    jgp = jgp._replace(unet=params, controlnet=None)
    x = _inputs(32, cond=False)
    want = _jax_eps(jsd, jgp, x)
    ranks = _port_eps(tmp_path, tsd, tgp._replace(unet=tunet), x)
    assert [r["heads"] for r in ranks] == [[1], [2]]
    for r in ranks:
        np.testing.assert_allclose(r["eps"], want, rtol=RTOL, atol=ATOL)


def test_more_ranks_than_heads_raise():
    _, _, _, tgp = tiny_guidance_pair(LAT)
    mesh = DataMesh(1, 0, torch.device("cpu"), tp=3)
    with pytest.raises(ValueError, match="at least 3 heads"):
        TP.shard_guidance_params(tgp, mesh)
    assert TP.split_range(5, 2, 0) == (0, 2)
    assert TP.split_range(5, 2, 1) == (2, 5)


def test_sharded_block_input_gradient(tmp_path):
    """3 heads of 16 and a biased output: the ranks' output and input
    gradient equal the whole block's."""
    gen = torch.Generator().manual_seed(0)
    block = L.build(lambda: L.BasicTransformerBlock(48, 3, 16, 32), "cpu",
                    generator=gen)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.Linear) and m.bias is not None:
                m.bias.normal_(0.0, 0.5, generator=gen)
    x = torch.randn((2, 24, 48), generator=gen)
    ctx = torch.randn((2, 4, 32), generator=gen)
    w = torch.randn((2, 24, 48), generator=gen)
    inp = x.clone().requires_grad_(True)
    out = block(inp, ctx)
    (out * w).sum().backward()
    path = TR.save(tmp_path / "block.pt", dict(block=block, x=x, ctx=ctx,
                                               w=w))
    for r in TR.run_ranks(TR.tp_block_grad, 2, path):
        np.testing.assert_allclose(r["out"], out.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["grad"], inp.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)

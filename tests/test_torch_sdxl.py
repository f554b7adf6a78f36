"""The SD2.x and SDXL model cards of the port against the JAX package, in
float32 on the CPU at tiny widths: the addition-embed UNet and the
ControlNet with ``guess_mode`` (weights carried across by ``convert.py``),
the ViT-H and bigG text towers at a reduced depth (and their full
configs' parameter counts), ``ScoreDistillationXL.latent_gradients``, a
diffusers SDXL directory written from the port's tiny modules and read
back through ``load_guidance_xl``, the avatar SDS step on the tiny XL
guidance, and every SD card through ``load_guidance`` (v-prediction and
96^2 latents on the 768-v cards, the "!" padding of the ViT-H tokenizer).

The JAX weights are seeded numpy on ``jax.eval_shape``'s shapes (no Flax
initialisation runs). Tolerances: ``TOL`` (1e-4 relative, of the larger of
1 and the largest entry) for a model's outputs; the step's loss within
1e-4 and each gradient within 2e-3 relative plus 2e-4 of its largest
entry (``tests/torch_jax_pairs.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu import tests_support as jts
from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu.guidance import clip_text as JCT
from dreamwaltz_g_tpu.guidance.controlnet import ControlNet as JControlNet
from dreamwaltz_g_tpu.guidance.sds import GuidanceParams as JGP
from dreamwaltz_g_tpu.guidance.sds import ScoreDistillation as JSD
from dreamwaltz_g_tpu.guidance.sdxl import ScoreDistillationXL as JSDXL
from dreamwaltz_g_tpu.guidance.sdxl import make_add_time_ids as jtids
from dreamwaltz_g_tpu.guidance.unet import UNet2DCondition as JUNet
from dreamwaltz_g_tpu.guidance.unet import UNetConfig as JUNetConfig
from dreamwaltz_g_tpu.guidance.vae import AutoencoderKL as JVAE
from dreamwaltz_g_tpu.guidance.vae import tiny_vae_config as jtiny_vae
from dreamwaltz_g_tpu.nerf.encoder import TriplaneConfig as JTriplane
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.convert import avatar_state_from_numpy
from dreamwaltz_g_tpu_torch.configs import RenderConfig
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch as tcamera
from dreamwaltz_g_tpu_torch.guidance import clip_text as TCT
from dreamwaltz_g_tpu_torch.guidance import convert as TCV
from dreamwaltz_g_tpu_torch.guidance.controlnet import ControlNet
from dreamwaltz_g_tpu_torch.guidance.layers import build
from dreamwaltz_g_tpu_torch.guidance.sdxl import make_add_time_ids
from dreamwaltz_g_tpu_torch.guidance.unet import UNet2DCondition, UNetConfig
from dreamwaltz_g_tpu_torch.guidance.vae import tiny_vae_config
from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
from dreamwaltz_g_tpu_torch.training import optim as TO
from tests.test_torch_clip_text import _write_bpe, _write_model_dir
from tests.torch_jax_pairs import LOSS_RTOL, _seeded, grad_close
import tests.torch_threads  # noqa: F401  (per-worker threads)

TOL = 1e-4
LATENT = 8
B = 2
# tiny_guidance_xl's sizes: two tiny towers (32 + 24 wide, the second
# projected to 24), the addition-embed UNet on their 56-wide context
XL_UNET = dict(block_out_channels=(32, 64), layers_per_block=1,
               cross_attention_dim=56, num_heads=2, attn_down=(True, False),
               addition_embed=True, addition_pooled_dim=24,
               addition_time_embed_dim=8)
# a tiny SD2-style UNet: fixed 16-wide heads
SD2_UNET = dict(block_out_channels=(32, 64), layers_per_block=1,
                cross_attention_dim=32, head_dim=16, attn_down=(True, False))


def _close(j, t, tol=TOL):
    j = np.asarray(j)
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    assert j.shape == t.shape
    assert np.isfinite(j).all() and float(np.abs(j).max()) > 0
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol * max(
        1.0, float(np.abs(j).max())))


def _jax_unet_tree(jcfg, rng, xl=True):
    key = jax.random.PRNGKey(0)
    lat = jnp.zeros((1, LATENT, LATENT, 4))
    ctx = jnp.zeros((1, 4, jcfg.cross_attention_dim))
    t0 = jnp.zeros((1,), jnp.int32)
    kw = dict(pooled_embeds=jnp.zeros((1, jcfg.addition_pooled_dim)),
              add_time_ids=jnp.zeros((1, 6))) if xl else {}
    unet = _seeded(jax.eval_shape(
        lambda k: JUNet(jcfg).init(k, lat, t0, ctx, **kw), key), rng)
    cn = _seeded(jax.eval_shape(
        lambda k: JControlNet(jcfg, cond_block_channels=(16, 32)).init(
            k, lat, t0, ctx, jnp.zeros((1, 2 * LATENT, 2 * LATENT, 3)),
            **kw), key), rng)
    vae = _seeded(jax.eval_shape(
        lambda k: JVAE(jtiny_vae()).init(k, image_size=2 * LATENT), key), rng)
    return dict(unet=unet, controlnet=cn, vae=vae)


@pytest.fixture(scope="module")
def xl():
    """The JAX tiny XL stack (with a ControlNet on its config) and the
    port's twin: (JAX ScoreDistillationXL, its params, port
    ScoreDistillationXL, its params), both with the same pooled
    embeddings."""
    rng = np.random.default_rng(0)
    jcfg = JUNetConfig(**XL_UNET)
    trees = _jax_unet_tree(jcfg, rng)
    pooled = rng.normal(size=(2, 24)).astype(np.float32)
    jsd = JSDXL(unet=JUNet(jcfg), vae=JVAE(jtiny_vae()),
                controlnet=JControlNet(jcfg, cond_block_channels=(16, 32)),
                latent_size=LATENT, guidance_scale=7.5,
                pooled_text=jnp.asarray(pooled[:1]),
                pooled_uncond=jnp.asarray(pooled[1:]))
    jgp = JGP(**{k: jax.tree_util.tree_map(jnp.asarray, v)
                 for k, v in trees.items()})
    tsd, tgp, _ = tts.tiny_guidance_xl(1, device="cpu")
    cn = build(lambda: ControlNet(UNetConfig(**XL_UNET), (16, 32)), "cpu")
    tgp = tgp._replace(controlnet=cn)
    convert.unet_from_flax(tgp.unet, trees["unet"])
    convert.vae_from_flax(tgp.vae, trees["vae"])
    convert.controlnet_from_flax(cn, trees["controlnet"])
    tsd.pooled_text = torch.as_tensor(pooled[:1])
    tsd.pooled_uncond = torch.as_tensor(pooled[1:])
    return jsd, jgp, tsd, tgp


def _inputs(seed, D=56):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        lat=rng.normal(size=(B, LATENT, LATENT, 4)).astype(f),
        t=np.array([999, 120], np.int32),
        ctx=rng.normal(size=(B, 4, D)).astype(f),
        unc=rng.normal(size=(B, 4, D)).astype(f) * 0.3,
        neg=rng.normal(size=(B, 4, D)).astype(f),
        pooled=rng.normal(size=(B, 24)).astype(f),
        cond=rng.uniform(size=(B, 2 * LATENT, 2 * LATENT, 3)).astype(f))


def test_addition_embed_unet_and_guess_mode_controlnet_match_jax(xl):
    """The 'text_time' conditioning in the UNet and the ControlNet, the
    ControlNet's residuals ramped by ``guess_mode``, the UNet fed them."""
    jsd, jgp, tsd, tgp = xl
    x = _inputs(2)
    T = torch.as_tensor
    jt = jtids(B)
    tt = make_add_time_ids(B, device="cpu")
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    cn_apply = jax.jit(
        lambda guess: jsd.controlnet.apply(
            jgp.controlnet, x["lat"], x["t"], x["ctx"], x["cond"], 0.8,
            pooled_embeds=x["pooled"], add_time_ids=jt, guess_mode=guess),
        static_argnums=0)
    for guess in (False, True):
        jr = cn_apply(guess)
        with torch.no_grad():
            tr = tgp.controlnet(T(x["lat"]), T(x["t"]), T(x["ctx"]),
                                T(x["cond"]), 0.8, guess_mode=guess,
                                pooled_embeds=T(x["pooled"]),
                                add_time_ids=tt)
        assert len(jr[0]) == len(tr[0]) == 4
        for a, b in zip(jr[0] + [jr[1]], tr[0] + [tr[1]]):
            _close(a, b)
    with torch.no_grad():
        got = tgp.unet(T(x["lat"]), T(x["t"]), T(x["ctx"]),
                       down_residuals=tr[0], mid_residual=tr[1],
                       pooled_embeds=T(x["pooled"]), add_time_ids=tt)
        with pytest.raises(ValueError):
            tgp.unet(T(x["lat"]), T(x["t"]), T(x["ctx"]))
    _close(jax.jit(lambda r: jsd.unet.apply(
        jgp.unet, x["lat"], x["t"], x["ctx"], down_residuals=r[0],
        mid_residual=r[1], pooled_embeds=x["pooled"], add_time_ids=jt))(jr),
        got)


@pytest.mark.parametrize("name", ["clip_h_config", "clip_bigg_config"])
def test_sd2_and_sdxl_towers_match_jax(name):
    """The ViT-H and bigG towers at two layers against the JAX towers (the
    mode each card reads: ViT-H's final states, bigG's penultimate states
    and projected pooled output), and the full configs' parameter counts
    (the port built on the meta device, the JAX tree by ``eval_shape``)."""
    full_j, full_t = getattr(JCT, name)(), getattr(TCT, name)()
    assert tuple(full_j) == tuple(full_t)
    mode = "penultimate_pooled" if full_t.projection_dim else "final"
    ids0 = jnp.zeros((1, 77), jnp.int32)
    shapes = jax.eval_shape(lambda k: JCT.CLIPTextModel(full_j).init(
        k, ids0, mode=mode), jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        n_port = sum(p.numel() for p in TCT.CLIPTextModel(full_t)
                     .parameters())
    assert n_jax == n_port
    assert n_port > (6e8 if full_t.projection_dim else 3e8)

    jcfg, tcfg = full_j._replace(num_layers=2), full_t._replace(num_layers=2)
    jm = JCT.CLIPTextModel(jcfg)
    tree = _seeded(jax.eval_shape(lambda k: jm.init(k, ids0, mode=mode),
                                  jax.random.PRNGKey(0)),
                   np.random.default_rng(3))
    tower = TCT.CLIPTextModel(tcfg)
    convert.clip_text_from_flax(tower, tree)
    ids = np.random.default_rng(4).integers(1, 49406, (2, 77)).astype(
        np.int32)
    ids[:, 0], ids[:, 9] = 49406, 49407
    jout = jax.jit(lambda p, i: jm.apply(p, i, mode=mode))(
        tree, jnp.asarray(ids))
    with torch.no_grad():
        tout = tower(torch.as_tensor(ids), mode=mode)
    if mode == "final":
        assert tout.shape == (2, 77, 1024)
        _close(jout, tout)
    else:
        assert tout[0].shape == (2, 77, 1280) and tout[1].shape == (2, 1280)
        _close(jout[0], tout[0])
        _close(jout[1], tout[1])


@pytest.mark.parametrize("fields,neg,progress", [
    (dict(loss_type="sds"), False, None),
    (dict(loss_type="csd"), True, 0.6),
    (dict(loss_type="z0_final", denoise_timesteps=5), False, None),
])
def test_xl_latent_gradients_match_jax(xl, fields, neg, progress):
    """``ScoreDistillationXL.latent_gradients`` with the ControlNet: the
    pooled embeddings per CFG branch, the single-branch pass (csd's
    negative) with the text branch's, the z0 walk."""
    jsd, jgp, tsd, tgp = xl
    jsd = dataclasses.replace(jsd, **fields)
    tsd = dataclasses.replace(tsd, **fields)
    x = _inputs(5)
    key = jax.random.PRNGKey(6)
    k = jax.random.split(key)[1 if fields["loss_type"] == "z0_final" else 0]
    noise = np.asarray(jax.random.normal(k, x["lat"].shape, jnp.float32))
    jg = jax.jit(lambda lat: jsd.latent_gradients(
        jgp, lat, x["ctx"], x["unc"], x["t"], key, cond_image=x["cond"],
        neg_embeds=x["neg"] if neg else None, progress=progress))(x["lat"])
    T = torch.as_tensor
    tg = tsd.latent_gradients(
        tgp, T(x["lat"]), T(x["ctx"]), T(x["unc"]), T(x["t"]),
        noise=T(noise), cond_image=T(x["cond"]),
        neg_embeds=T(x["neg"]) if neg else None, progress=progress)
    _close(jg, tg)


def test_xl_directory_round_trip(tmp_path):
    """``load_guidance_xl`` over a diffusers SDXL directory written from
    the port's tiny modules (the UNet in bf16): every tensor back, the
    embedding function the two towers' penultimate states side by side
    and tower 2's projected pooled output, the loaded stack's eps equal to
    the written one's; the ControlNet comes from ``controlnet_pose/``."""
    vpath, mpath, n_vocab = _write_bpe(tmp_path)
    t1 = TCT.tiny_text_config()._replace(vocab_size=n_vocab)
    t2 = t1._replace(projection_dim=24, hidden_size=24)
    sd, gp, _ = tts.tiny_guidance_xl(3, device="cpu")
    cn = build(lambda: ControlNet(UNetConfig(**XL_UNET), (16, 32)), "cpu",
               generator=torch.Generator().manual_seed(5))
    clip1 = TCT.CLIPTextModel(t1)
    clip1.reset_parameters(torch.Generator().manual_seed(6))
    clip2 = TCT.CLIPTextModel(t2)
    clip2.reset_parameters(torch.Generator().manual_seed(7))
    root = tmp_path / "xl"
    _write_model_dir(root, gp._replace(controlnet=cn), clip1, vpath, mpath)
    (root / "text_encoder_2").mkdir()
    torch.save(clip2.state_dict(),
               root / "text_encoder_2" / "pytorch_model.bin")
    (root / "tokenizer_2").mkdir()
    configs = dict(unet=UNetConfig(**XL_UNET), vae=tiny_vae_config(),
                   text=t1, text_2=t2, cond_block_channels=(16, 32),
                   latent_size=LATENT)
    lsd, lgp, embed = TCV.load_guidance_xl(
        str(root), configs=configs, use_controlnet=True, device="cpu",
        loss_type="nfsd", denoise_timesteps=7, guess_mode=True)
    assert (lsd.loss_type, lsd.denoise_timesteps, lsd.latent_size,
            lsd.guess_mode) == ("nfsd", 7, LATENT, True)
    for name, src in (("vae", gp.vae), ("controlnet", cn)):
        got = getattr(lgp, name).state_dict()
        for k, v in src.state_dict().items():
            assert torch.equal(got[k], v), (name, k)
    for k, v in gp.unet.state_dict().items():
        assert torch.equal(lgp.unet.state_dict()[k],
                           v.to(torch.bfloat16).float()), k
    tok = TCT.CLIPTokenizer(vpath, mpath, max_length=t1.max_length)
    texts = ["hello world", "a person"]
    ids = torch.as_tensor(tok(texts))
    embeds, pooled = embed(texts)
    h2, want_pooled = clip2(ids, mode="penultimate_pooled")
    assert embeds.shape == (2, t1.max_length, 56) and pooled.shape == (2, 24)
    assert torch.equal(embeds, torch.cat(
        [clip1(ids, mode="penultimate"), h2], -1))
    assert torch.equal(pooled, want_pooled)
    lsd.pooled_text, lsd.pooled_uncond = pooled[:1], pooled[1:]
    x = _inputs(7)
    T = torch.as_tensor
    with torch.no_grad():
        eps = lsd._cfg_eps(lgp, T(x["lat"]), T(x["t"]), embeds, embeds,
                           T(x["cond"]), 7.5)[0]
        gp_bf = gp._replace(controlnet=cn)
        gp_bf.unet.load_state_dict(lgp.unet.state_dict())
        want = lsd._cfg_eps(gp_bf, T(x["lat"]), T(x["t"]), embeds, embeds,
                            T(x["cond"]), 7.5)[0]
    assert torch.equal(eps, want)
    _, nocn, _ = TCV.load_guidance_xl(str(root), configs=configs,
                                      device="cpu")
    assert nocn.controlnet is None


def test_xl_avatar_sds_step_matches_jax():
    """The avatar SDS step on the tiny XL guidance (the JAX package's
    ``test_sdxl_avatar_sds_step`` drive: pooled text from the prompt, a
    zero null branch, t = 400), the port's ``make_avatar_sds_step`` against
    ``jax.value_and_grad`` of the JAX step's loss: the loss, the gradients
    of the positions, the triplane and the screen-space dummy."""
    H = W = 16
    raster = dict(tile_size=8, capacity=64, chunk=32,
                  max_tiles_per_gaussian=16)
    jset = jts.tiny_avatar_setup(enc_cfg=JTriplane(resolution=16,
                                                   feature_dim=8))
    rng = np.random.default_rng(0)
    jcfg = JUNetConfig(**XL_UNET)
    trees = _jax_unet_tree(jcfg, rng)
    txt = rng.normal(size=(1, 16, 56)).astype(np.float32)
    pooled = rng.normal(size=(1, 24)).astype(np.float32)
    bg = rng.uniform(size=(H, W, 3)).astype(np.float32)
    jsd = JSDXL(unet=JUNet(jcfg), vae=JVAE(jtiny_vae()), latent_size=LATENT,
                guidance_scale=7.5, pooled_text=jnp.asarray(pooled),
                pooled_uncond=jnp.asarray(pooled * 0))
    jgp = JGP(unet=jax.tree_util.tree_map(jnp.asarray, trees["unet"]),
              vae=jax.tree_util.tree_map(jnp.asarray, trees["vae"]))
    cam = (2.5, 0.0, 80.0, 60.0)
    jc = jcamera(*cam, H, W, at_vector=((0, 0.7, 0),))
    key = jax.random.PRNGKey(2)
    t = np.asarray([400], np.int32)
    state = jset.state
    C = state.capacity

    def loss_fn(params, dummy):
        image, out = JG._render_with_dummy(
            jset.model, state, params, jset.observed, dummy,
            jc.extrinsic[0], jc.intrinsics[0], jc.tanfov[0], bg, H, W,
            raster)
        return jsd(jgp, image[None], txt, txt * 0, t, key)["loss"], out.alpha

    (loss, alpha), (grads, dgrad) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(
        state.params, jnp.zeros((C + jset.model.n_mesh_points, 2)))
    assert float(alpha.max()) > 0.5

    tset = tts.tiny_avatar_setup(device="cpu")
    tsd, tgp, _ = tts.tiny_guidance_xl(1, device="cpu")
    convert.unet_from_flax(tgp.unet, trees["unet"])
    convert.vae_from_flax(tgp.vae, trees["vae"])
    T = torch.as_tensor
    tsd.pooled_text, tsd.pooled_uncond = T(pooled), T(pooled * 0)
    tstate = TG.init_avatar_train_state(
        avatar_state_from_numpy(jax.tree_util.tree_map(np.asarray, state),
                                tset.model, device="cpu"),
        TO.build_avatar_optimizer(RenderConfig(), 50), tset.model)
    positions = tstate.avatar.params.positions
    planes = tstate.avatar.params.encoder.planes
    step = TG.make_avatar_sds_step(tset.model, tsd, H, W, device="cpu",
                                   **raster)
    tc = tcamera(*cam, H, W, at_vector=((0, 0.7, 0),), device="cpu")
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0],
                                         (1, LATENT, LATENT, 4)))
    new, metrics = step(tstate, tgp, tset.observed, tc.extrinsic[0],
                        tc.intrinsics[0], tc.tanfov[0], T(bg), T(txt),
                        T(txt * 0), T(t), noise=T(noise))
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=LOSS_RTOL)
    grad_close("positions", positions.grad.numpy(), grads.positions)
    grad_close("planes", planes.grad.numpy(), grads.encoder.planes)
    assert new.step == 1


def test_every_sd_card_loads(tmp_path):
    """Each card of ``MODEL_FAMILIES`` through ``load_guidance`` over one
    tiny directory (an SD2-style UNet, a gelu tower): the prediction type
    and latent grid of the card, the ViT-H cards' tokenizer padding with
    "!" (id 0); the 768-v cards' latent gradient against the JAX
    package's v-prediction on the same weights."""
    rng = np.random.default_rng(0)
    trees = _jax_unet_tree(JUNetConfig(**SD2_UNET), rng, xl=False)
    vpath, mpath, n_vocab = _write_bpe(tmp_path)
    tcfg = TCT.tiny_text_config()._replace(vocab_size=n_vocab,
                                           activation="gelu")
    _, gp = tts.tiny_guidance(0, with_controlnet=True, device="cpu")
    unet = build(lambda: UNet2DCondition(UNetConfig(**SD2_UNET)), "cpu")
    cn = build(lambda: ControlNet(UNetConfig(**SD2_UNET), (16, 32)), "cpu")
    convert.unet_from_flax(unet, trees["unet"])
    convert.controlnet_from_flax(cn, trees["controlnet"])
    convert.vae_from_flax(gp.vae, trees["vae"])
    clip = TCT.CLIPTextModel(tcfg)
    clip.reset_parameters(torch.Generator().manual_seed(4))
    root = tmp_path / "sd2"
    _write_model_dir(root, gp._replace(unet=unet, controlnet=cn), clip,
                     vpath, mpath)
    configs = dict(unet=UNetConfig(**SD2_UNET), vae=tiny_vae_config(),
                   text=tcfg, cond_block_channels=(16, 32))
    x = _inputs(8, D=32)
    T = torch.as_tensor
    # the directory holds the UNet in bf16: the JAX side takes the same
    bf16_unet = jax.tree_util.tree_map(
        lambda a: torch.as_tensor(np.asarray(a)).to(torch.bfloat16).float()
        .numpy(), trees["unet"])
    for card, fam in TCV.MODEL_FAMILIES.items():
        sd, lgp, embed = TCV.load_guidance(str(root), model=card,
                                           configs=configs, device="cpu")
        v = card in ("sd20", "sd21")
        assert sd.prediction_type == ("v_prediction" if v else "epsilon")
        assert sd.latent_size == (96 if v else 64) == fam["latent"]
        tok = TCT.CLIPTokenizer(vpath, mpath, max_length=tcfg.max_length)
        if fam["text"] == "clip_h":
            tok.pad_id = 0
        ids = tok(["a person"])
        assert ids[0, -1] == (0 if fam["text"] == "clip_h" else tok.eos)
        assert torch.equal(embed(["a person"]), clip(T(ids)))
        if not v:
            continue
        jsd = JSD(unet=JUNet(JUNetConfig(**SD2_UNET)), vae=JVAE(jtiny_vae()),
                  controlnet=JControlNet(JUNetConfig(**SD2_UNET),
                                         cond_block_channels=(16, 32)),
                  latent_size=LATENT, guidance_scale=sd.guidance_scale,
                  prediction_type="v_prediction")
        jgp = JGP(**{k: jax.tree_util.tree_map(jnp.asarray, v_)
                     for k, v_ in dict(trees, unet=bf16_unet).items()})
        key = jax.random.PRNGKey(9)
        noise = np.asarray(jax.random.normal(jax.random.split(key)[0],
                                             x["lat"].shape, jnp.float32))
        jg = jax.jit(lambda lat: jsd.latent_gradients(
            jgp, lat, x["ctx"], x["unc"], x["t"], key,
            cond_image=x["cond"]))(x["lat"])
        tg = sd.latent_gradients(lgp, T(x["lat"]), T(x["ctx"]), T(x["unc"]),
                                 T(x["t"]), noise=T(noise),
                                 cond_image=T(x["cond"]))
        _close(jg, tg)
    with pytest.raises(KeyError):
        TCV.load_guidance(str(root), model="sdxl10", device="cpu")

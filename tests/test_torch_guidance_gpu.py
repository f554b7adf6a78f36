"""The guidance's other families and the tiny XL guidance on the card
against the same calls on the CPU.

Marked ``gpu``: each test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so on a machine without them it runs as

    python -m pytest tests/test_torch_guidance_gpu.py -m gpu --noconftest -q

The tiny float32 guidance at 32^2 latents (1,024 tokens in the UNet's top
level and the VAE's mid block: the flash kernels on the card, their plain
version on the CPU, ``FLASH_ATTENTION = "on"``), the ControlNet's zero
convolutions given seeded values, a textured render (over a flat one the
VAE's GroupNorms see near-constant groups, which amplify rounding), the
same noise and negative branch on both: for each of custom, csd (with
``progress`` + ``neg_embeds``), nfsd (t on both sides of 200), ism
(two inversion strides), z0, z0_final, x0 and x0_final (a 10-step grid)
the loss within 1e-3 relative and the gradients, the target and the
image's gradient within ``2e-3 |cpu| + 2e-4 peak`` (``chip_smoke.py``'s
``small_train`` envelope); flash forwards launched, and flash backwards
for every family but the x0 modes, which launch none. The tiny XL
guidance (the addition-embed UNet, its pooled embeddings) likewise on
sds and csd.
"""
import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu

RTOL, ATOL_OF_MAX = 2e-3, 2e-4
REL_LOSS = 1e-3
L = 32
B = 2


def _card():
    """The card, resolved as the port's entry points resolve it (TF32 off
    for matmuls and convolutions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dreamwaltz_g_tpu_torch._device import resolve_device

    return resolve_device("cuda")


def _to(x, dev):
    """Tensors and modules inside tuples and dataclasses, moved."""
    if torch.is_tensor(x) or isinstance(x, torch.nn.Module):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_to(v, dev) for v in x])
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)})
    return x


def _live_controlnet(cn):
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for conv in [cn.controlnet_cond_embedding.conv_out,
                     cn.controlnet_mid_block, *cn.controlnet_down_blocks]:
            for t in (conv.weight, conv.bias):
                t.copy_(0.2 * torch.randn(t.shape, generator=gen))


def _inputs(D):
    gen = torch.Generator().manual_seed(0)
    yy, xx = torch.meshgrid(torch.linspace(0, 1, 2 * L),
                            torch.linspace(0, 1, 2 * L), indexing="ij")
    texture = torch.stack([torch.sin(9 * xx), torch.cos(7 * yy),
                           torch.sin(5 * (xx + yy))], -1) * 0.4 + 0.5
    return dict(
        img=(texture[None] + 0.1 * torch.rand((B, 2 * L, 2 * L, 3),
                                              generator=gen)).clamp(0, 1),
        ctx=torch.randn((B, 4, D), generator=gen),
        unc=0.3 * torch.randn((B, 4, D), generator=gen),
        neg=torch.randn((B, 4, D), generator=gen),
        t=torch.tensor([999, 120]),
        cond=torch.rand((B, 2 * L, 2 * L, 3), generator=gen),
        noise=torch.randn((B, L, L, 4), generator=gen))


def _close(name, got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert torch.isfinite(got).all(), name
    bound = RTOL * want.abs() + ATOL_OF_MAX * float(want.abs().max())
    err = (got - want).abs()
    assert bool((err <= bound).all()), (
        name, float((err - bound).max()), float(err.max()),
        float(want.abs().max()))


def _run(make, fields, dev, neg, progress, D):
    x = _inputs(D)
    out = {}
    from dreamwaltz_g_tpu_torch.guidance import flash as FL

    for d in (torch.device("cpu"), dev):
        sd, gp = make()
        sd = dataclasses.replace(_to(sd, d), **fields)
        gp = _to(gp, d)
        FL.flash_attn_fwd.launches = FL.flash_attn_bwd.launches = 0
        img = x["img"].to(d, copy=True).requires_grad_(True)
        res = sd(gp, img, x["ctx"].to(d), x["unc"].to(d), x["t"].to(d),
                 noise=x["noise"].to(d), cond_image=x["cond"].to(d),
                 neg_embeds=x["neg"].to(d) if neg else None,
                 progress=progress)
        res["loss"].backward()
        out[d.type] = dict(loss=float(res["loss"].detach()),
                           grads=res["gradients"],
                           target=res["target"], img_grad=img.grad,
                           launches=(FL.flash_attn_fwd.launches,
                                     FL.flash_attn_bwd.launches))
    cpu, card = out["cpu"], out["cuda"]
    assert abs(card["loss"] - cpu["loss"]) <= REL_LOSS * abs(cpu["loss"]), \
        (card["loss"], cpu["loss"])
    for name in ("grads", "target", "img_grad"):
        _close(name, card[name], cpu[name])
    fwd, bwd = card["launches"]
    assert fwd > 0 and bwd == (
        0 if fields["loss_type"].startswith("x0") else 1), card["launches"]


def _tiny():
    from dreamwaltz_g_tpu_torch import tests_support

    sd, gp = tests_support.tiny_guidance(0, with_controlnet=True,
                                         latent_size=L, device="cpu")
    _live_controlnet(gp.controlnet)
    return sd, gp


@pytest.mark.parametrize("fields,neg,progress", [
    (dict(loss_type="custom"), False, None),
    (dict(loss_type="csd"), True, 0.4),
    (dict(loss_type="nfsd"), True, None),
    (dict(loss_type="ism", weight_type="ism", ism_xs_inv_steps=2), False,
     0.5),
    (dict(loss_type="z0", denoise_timesteps=10), False, None),
    (dict(loss_type="z0_final", denoise_timesteps=10), False, None),
    (dict(loss_type="x0", denoise_timesteps=10), False, None),
    (dict(loss_type="x0_final", denoise_timesteps=10), False, None),
])
def test_family_card_matches_cpu(monkeypatch, fields, neg, progress):
    dev = _card()
    from dreamwaltz_g_tpu_torch.guidance import layers as TL

    monkeypatch.setattr(TL, "FLASH_ATTENTION", "on")
    _run(_tiny, fields, dev, neg, progress, 32)


@pytest.mark.parametrize("fields,neg,progress", [
    (dict(loss_type="sds"), False, None),
    (dict(loss_type="csd"), True, 0.7),
])
def test_xl_card_matches_cpu(monkeypatch, fields, neg, progress):
    dev = _card()
    from dreamwaltz_g_tpu_torch import tests_support
    from dreamwaltz_g_tpu_torch.guidance import layers as TL

    monkeypatch.setattr(TL, "FLASH_ATTENTION", "on")

    def make():
        sd, gp, embed = tests_support.tiny_guidance_xl(0, latent_size=L,
                                                       device="cpu")
        _, pooled = embed(["a dancer", ""])
        sd.pooled_text, sd.pooled_uncond = pooled[:1], pooled[1:]
        return sd, gp

    _run(make, fields, dev, neg, progress, 56)

"""The guidance's other paths through the port's CLI (``main``) on the
CPU, two stage-2 steps each on the debug guidance: ``--guide.sds_loss_type
csd`` (the negative branch drawn from the trainer's generator, the batch's
``progress`` into every step), ``ism`` (its own timestep window), ``x0``
with ``--render.use_mlp_background`` (the fused step, as the JAX trainer
routes the x0 modes: the background is not trained), and ``--guide.diffusion
sdxl10`` (the tiny XL guidance, its pooled embeddings from the first
prompt)."""
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (per-worker threads)


def _args(tmp_path, name, extra):
    return ["--stage", "gs", "--optim.iters", "2",
            "--log.save_interval", "0", "--data.train_w", "16",
            "--data.train_h", "16", "--render.n_gaussians", "96",
            "--prompt.scene", "canonical-R",
            "--log.debug", "true", "--log.platform", "cpu",
            "--log.exp_root", str(tmp_path), "--log.exp_name", name,
            "--nerf.triplane_resolution", "16", "--nerf.triplane_dim", "8",
            "--data.eval_h", "16", "--data.eval_w", "16",
            "--log.snapshot_interval", "0",
            "--log.evaluate_interval", "0"] + extra


@pytest.mark.parametrize("case", ["csd", "ism", "x0_mlp_background",
                                  "sdxl10"])
def test_guidance_cli_trains(tmp_path, monkeypatch, case):
    from dreamwaltz_g_tpu_torch.guidance.sds import ScoreDistillation
    from dreamwaltz_g_tpu_torch.main import main
    from dreamwaltz_g_tpu_torch.training import gs_trainer

    extra = {"csd": ["--guide.sds_loss_type", "csd"],
             "ism": ["--guide.sds_loss_type", "ism",
                     "--guide.sds_weight_type", "ism"],
             "x0_mlp_background": ["--guide.sds_loss_type", "x0",
                                   "--guide.denoise_timesteps", "10",
                                   "--render.use_mlp_background", "true"],
             "sdxl10": ["--guide.diffusion", "sdxl10"]}[case]
    calls, built = [], []
    call = ScoreDistillation.__call__

    def spy(self, *a, **kw):
        calls.append((self.loss_type, kw.get("neg_embeds"),
                      kw.get("progress")))
        return call(self, *a, **kw)

    monkeypatch.setattr(ScoreDistillation, "__call__", spy)
    for name in ("make_avatar_sds_step", "make_avatar_sds_step_split"):
        make = getattr(gs_trainer, name)
        monkeypatch.setattr(
            gs_trainer, name,
            lambda *a, _m=make, _n=name, **kw: built.append(_n) or _m(*a,
                                                                      **kw))
    tr = main(_args(tmp_path, case, extra))
    assert tr.train_step == 2
    assert len(tr.losses) == 2 and np.isfinite(tr.losses).all()
    assert tr.guidance.loss_type == (extra[1] if "--guide.sds_loss_type"
                                     in extra else "sds")
    assert built == ["make_avatar_sds_step"]    # x0: fused, not split
    assert [c[2] for c in calls] == [0.5, 1.0]  # step / max_iteration
    if case == "csd":
        neg = calls[0][1]
        assert neg is tr.neg_embeds and neg.shape == (1, 4, 32)
        assert neg.dtype == tr.text_embeds.dtype
    else:
        assert tr.neg_embeds is None and calls[0][1] is None
    if case == "x0_mlp_background":
        assert tr.bg_state is not None
        assert all(p.grad is None for p in tr.bg_net.parameters())
    if case == "sdxl10":
        from dreamwaltz_g_tpu_torch.guidance.sdxl import ScoreDistillationXL

        assert isinstance(tr.guidance, ScoreDistillationXL)
        assert tr.text_embeds.shape[1:] == (16, 56)
        assert tr.guidance.pooled_text.shape == (1, 24)
        assert tr.guidance.pooled_uncond.shape == (1, 24)
        assert not torch.equal(tr.guidance.pooled_text,
                               tr.guidance.pooled_uncond)

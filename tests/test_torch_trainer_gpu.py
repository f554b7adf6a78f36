"""The port's CLI chain on the card against the same chain on the CPU.

Marked ``gpu``: skips without a CUDA card. This file imports neither JAX
nor the JAX package, so on a machine without them it runs as

    python -m pytest tests/test_torch_trainer_gpu.py -m gpu --noconftest -q

The chain is the tiny one of ``tests/test_torch_trainer.py``: ``--stage
nerf`` for 2 steps, then ``--stage gs --render.from_nerf`` for 1 step, with
the synthetic body and the tiny guidance in float32 (``--guide.dtype
fp32``; bf16's roundings differ between the card's and the CPU's
convolutions). Every random draw comes from host generators on both
devices (the trainer's, the prompt's and the initialisers' generators are
made on the CPU and their draws moved to the card), so both runs see the
same numbers. Tolerances:
* each step's loss, 1e-3 relative (``chip_smoke.py``'s ``TOL_STEP_LOSS``);
* each step's gradient of each parameter within
  ``|card - cpu| <= 2e-3 |cpu| + 2e-4 peak`` (the envelope of
  ``chip_smoke.py``'s ``small_train`` / ``small_nerf_train``), the peak
  being the stage's largest gradient entry at that step: two CPU runs of
  stage 2 already differ by ~1e-5 of the largest gradient (the plain
  blend's scatter-adds are not ordered), and a group whose gradient is
  ~1e-10 everywhere (the quaternions') has no scale of its own;
* each parameter's value within ``2e-3 |cpu| + 2e-4 peak`` (the tensor's
  largest entry) plus ``_adam_reach``: the most Adam's updates can move an
  entry when each step's gradient may lie anywhere in the envelope above.
  Where a gradient lies inside its envelope around zero its sign is not
  determined and Adam's first update is +-lr whatever its size (eps
  1e-15), so there the reach is 2 lr a step; where every gradient stands
  clear of zero it is a small share of lr, and a skipped or sign-flipped
  update on the card fails.
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

REL_LOSS = 1e-3
RTOL, ATOL_OF_MAX = 2e-3, 2e-4


def _tiny(tmp_path, name, platform):
    return [
        "--log.debug", "true", "--log.exp_root", str(tmp_path / platform),
        "--log.exp_name", name, "--log.platform", platform,
        "--guide.dtype", "fp32",
        "--nerf.triplane_resolution", "16", "--nerf.triplane_dim", "8",
        "--data.train_w", "16", "--data.train_h", "16",
        "--log.snapshot_interval", "0", "--log.evaluate_interval", "0",
    ]


def _host_draws(monkeypatch):
    """Generators made on the CPU; a draw asked of the card comes from the
    host generator and is moved there."""
    gen = torch.Generator

    class HostGenerator(gen):
        def __new__(cls, device=None):
            return gen()

    monkeypatch.setattr(torch, "Generator", HostGenerator)

    def moved(fn):
        def draw(*args, generator=None, device=None, **kw):
            if generator is not None and device is not None \
                    and torch.device(device).type == "cuda":
                return fn(*args, generator=generator, **kw).to(device)
            return fn(*args, generator=generator, device=device, **kw)
        return draw

    for name in ("rand", "randn", "randint"):
        monkeypatch.setattr(torch, name, moved(getattr(torch, name)))
    multinomial = torch.multinomial

    def host_multinomial(probs, n, replacement=False, generator=None):
        return multinomial(probs.cpu(), n, replacement,
                           generator=generator).to(probs.device)

    monkeypatch.setattr(torch, "multinomial", host_multinomial)
    for name in ("normal_", "uniform_"):
        monkeypatch.setattr(torch.Tensor, name,
                            host_inplace(getattr(torch.Tensor, name)))
    # the volume-sparsity draws are made on the generator's device
    from dreamwaltz_g_tpu_torch.training import nerf_trainer

    loss = nerf_trainer.volume_sparsity_loss

    def moved_loss(model, draws, **kw):
        dev = model.planes.device
        return loss(model, type(draws)(*[None if x is None else x.to(dev)
                                         for x in draws]), **kw)

    monkeypatch.setattr(nerf_trainer, "volume_sparsity_loss", moved_loss)


def host_inplace(fill):
    """An in-place draw (``normal_``, ``uniform_``) on a card tensor from a
    host generator: drawn on the host, copied in."""
    def draw(t, a=0.0, b=1.0, generator=None):
        if t.is_cuda and generator is not None:
            return t.copy_(fill(torch.empty(t.shape, dtype=t.dtype), a, b,
                                generator=generator))
        return fill(t, a, b, generator=generator)
    return draw


def _record_steps(monkeypatch):
    """Each trainer step's gradients, moved to the host, by stage:
    ``steps[stage][k][label][i]`` (None where a tensor has none)."""
    from dreamwaltz_g_tpu_torch.training import trainer as T
    from dreamwaltz_g_tpu_torch.training.optim import (
        avatar_param_groups,
        nerf_param_groups,
    )

    steps = {"nerf": [], "gs": []}
    one = T.Trainer._train_one

    def train_one(self, batch):
        metrics = one(self, batch)
        named = nerf_param_groups(self.nerf) if self.cfg.stage == "nerf" \
            else avatar_param_groups(self.state.avatar.params,
                                     self.avatar_model)
        steps[self.cfg.stage].append(
            {k: [None if p.grad is None else p.grad.detach().cpu().clone()
                 for p in ps] for k, ps in named.items()})
        return metrics

    monkeypatch.setattr(T.Trainer, "_train_one", train_one)
    return steps


def _chain(tmp_path, platform, steps):
    """The chain on ``platform``: (stage-1 losses, stage-2 losses, and for
    each stage ``{label: [(value, [gradient a step], adam)]}``, ``adam``
    the tensor's Adam settings and learning rate a step)."""
    from dreamwaltz_g_tpu_torch.main import main

    for s in steps.values():
        s.clear()
    t1 = main(["--stage", "nerf", "--optim.iters", "2",
               "--log.save_interval", "2"]
              + _tiny(tmp_path, "s1", platform))
    t2 = main(["--stage", "gs", "--optim.iters", "1",
               "--render.from_nerf", str(t1.exp_dir),
               "--render.n_gaussians", "128",
               "--render.nerf_resolution", "24",
               "--nerf.density_thresh", "1e-4",
               "--log.save_interval", "0"]
              + _tiny(tmp_path, "s2", platform))
    from dreamwaltz_g_tpu_torch.training.optim import (
        avatar_param_groups,
        nerf_param_groups,
    )

    def lr_at(lr, count):
        return float(lr(count) if callable(lr) else lr)

    # each label's Adam: the NeRF rules (optax's order, lr read at the
    # count before the update), the avatar's torch Adam groups
    n1, n2 = len(steps["nerf"]), len(steps["gs"])
    adam = {}
    for label, (_, rule, _) in t1.state.opt_state.groups.items():
        adam["nerf", label] = dict(
            b1=rule.b1, b2=rule.b2, eps=rule.eps, wd=rule.weight_decay,
            lrs=[lr_at(rule.lr, k) for k in range(n1)])
    opt = t2.state.opt_state
    for group, lr in zip(opt.adam.param_groups, opt.schedules):
        assert group["weight_decay"] == 0.0
        adam["gs", group["name"]] = dict(
            b1=group["betas"][0], b2=group["betas"][1], eps=group["eps"],
            wd=0.0, lrs=[lr_at(lr, k) for k in range(n2)])
    frozen = dict(b1=0.9, b2=0.999, eps=1e-15, wd=0.0)

    def groups(stage, named):
        out = {}
        for label, ps in named.items():
            a = adam.get((stage, label),
                         dict(frozen, lrs=[0.0] * len(steps[stage])))
            out[label] = [(p.detach().cpu(),
                           [s[label][i] for s in steps[stage]], a)
                          for i, p in enumerate(ps)]
        return out

    return (t1.losses, t2.losses, groups("nerf", nerf_param_groups(t1.nerf)),
            groups("gs", avatar_param_groups(t2.state.avatar.params,
                                             t2.avatar_model)))


def _adam_reach(hs, es, adam):
    """The most Adam's summed updates can differ, entry by entry, between
    the gradients ``hs`` (one a step) and any gradients within ``es`` of
    them: interval arithmetic on the moments. The first moment is linear
    in the gradients, so its interval is exact; the second moment's takes
    each square over its interval; the update is their quotient, capped by
    Cauchy-Schwarz at ``sqrt(c2 sum_j a_j^2 / b_j) / c1`` (a_j, b_j the
    moments' weights of step j). Decoupled weight decay moves a value by
    ``lr wd`` of the values' own difference a step."""
    b1, b2, eps, wd = adam["b1"], adam["b2"], adam["eps"], adam["wd"]
    reach = torch.zeros_like(hs[0])
    m = m_lo = m_hi = v = v_lo = v_hi = torch.zeros_like(hs[0])
    for k, (h, e, lr) in enumerate(zip(hs, es, adam["lrs"]), 1):
        m = b1 * m + (1 - b1) * h
        m_lo = b1 * m_lo + (1 - b1) * (h - e)
        m_hi = b1 * m_hi + (1 - b1) * (h + e)
        v = b2 * v + (1 - b2) * h * h
        v_lo = b2 * v_lo + (1 - b2) * (h.abs() - e).clamp(min=0) ** 2
        v_hi = b2 * v_hi + (1 - b2) * (h.abs() + e) ** 2
        c1, c2 = 1 - b1 ** k, 1 - b2 ** k
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        d_lo = torch.sqrt(v_lo / c2) + eps
        d_hi = torch.sqrt(v_hi / c2) + eps
        a, b = m_lo / c1, m_hi / c1
        cap = (c2 * sum(((1 - b1) * b1 ** (k - j)) ** 2
                        / ((1 - b2) * b2 ** (k - j))
                        for j in range(1, k + 1))) ** 0.5 / c1
        lo = torch.where(a >= 0, a / d_hi, a / d_lo).clamp(-cap, cap)
        hi = torch.where(b >= 0, b / d_lo, b / d_hi).clamp(-cap, cap)
        reach = reach * (1 + lr * wd) \
            + lr * torch.maximum(u - lo, hi - u).clamp(min=0)
    return reach


def _within(got, want, what, peak=None, adam=0.0):
    peak = want.abs().max() if peak is None else peak
    bound = RTOL * want.abs() + ATOL_OF_MAX * peak + adam
    excess = float(((got - want).abs() - bound).max())
    assert excess <= 0.0, f"{what}: {excess} over the envelope"


def test_cli_chain_card_matches_cpu(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _host_draws(monkeypatch)
    steps = _record_steps(monkeypatch)
    card = _chain(tmp_path, "cuda", steps)
    cpu = _chain(tmp_path, "cpu", steps)
    for got, want in zip(card[:2], cpu[:2]):
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert abs(a - b) <= REL_LOSS * abs(b), (got, want)
    for stage, (got, want) in enumerate(zip(card[2:], cpu[2:]), 1):
        assert set(got) == set(want)
        entries = [e for ts in want.values() for e in ts]
        n = len(entries[0][1])
        assert n == (2 if stage == 1 else 1)
        peaks = [max(float(hs[k].abs().max()) for _, hs, _ in entries
                     if hs[k] is not None) for k in range(n)]
        moved = 0
        for label in want:
            for i, ((p, gs, _), (q, hs, adam)) in enumerate(zip(got[label],
                                                               want[label])):
                what = f"stage {stage} {label}[{i}]"
                for k, (g, h) in enumerate(zip(gs, hs)):
                    assert (g is None) == (h is None), what
                    if h is not None:
                        _within(g, h, f"{what} gradient at step {k + 1}",
                                peaks[k])
                hs = [torch.zeros_like(q) if h is None else h for h in hs]
                es = [torch.zeros_like(q) if h is None
                      else RTOL * h.abs() + ATOL_OF_MAX * peak
                      for h, peak in zip(hs, peaks)]
                reach = _adam_reach(hs, es, adam)
                _within(p, q, f"{what} value", adam=reach)
                moved += int((reach < 0.5 * max(adam["lrs"], default=0.0))
                             .sum())
        # entries whose reach is below half a step's update: there a
        # skipped or flipped update is seen
        assert moved > 0, f"stage {stage}: no entry holds Adam's update"


TOL_B2 = 5e-3    # chip_smoke.py's TOL_RGB_ALPHA: B2 against its plain version


def test_full_eval_card_matches_cpu(tmp_path, monkeypatch):
    """``--log.eval_only`` on one tiny avatar checkpoint (trained on the
    CPU, and written again under the card's experiment root without its
    generator states, which are the CPU generators'; the demo motion's
    eval draws nothing): a demo motion's 4 frames at 24 x 32 (partial
    16-pixel tiles) through B2 on the card, once a frame, against the same
    frames on the CPU, within B2's tolerance."""
    import numpy as np

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dreamwaltz_g_tpu_torch.configs import paths
    from dreamwaltz_g_tpu_torch.main import main
    from dreamwaltz_g_tpu_torch.ops import blend
    from dreamwaltz_g_tpu_torch.training.checkpoint import (
        load_pytree,
        resolve_ckpt_path,
        save_pytree,
    )
    from dreamwaltz_g_tpu_torch.training.trainer import Trainer

    t = np.linspace(0, 1, 6, dtype=np.float32)[:, None]
    np.save(tmp_path / "talkshow.npy",
            0.3 * np.sin(t + np.arange(265, dtype=np.float32)))
    monkeypatch.setattr(paths, "DEMO_MOTIONS", str(tmp_path))
    main(["--stage", "gs", "--optim.iters", "1", "--log.save_interval", "1",
          "--render.n_gaussians", "128"] + _tiny(tmp_path, "av", "cpu"))
    step_dir = resolve_ckpt_path(tmp_path / "cpu" / "av")
    tree = load_pytree(step_dir)
    del tree["rng"]
    save_pytree(tmp_path / "cuda" / "av" / "checkpoints" / step_dir.name,
                tree)
    frames = {}
    evaluate = Trainer.evaluate

    def record(self, *args, **kw):
        out = evaluate(self, *args, **kw)
        frames[self.device.type] = out
        return out

    monkeypatch.setattr(Trainer, "evaluate", record)
    argv = ["--stage", "gs", "--log.eval_only", "true",
            "--optim.resume", "true", "--prompt.scene", "demo,talkshow",
            "--data.full_eval_size", "4", "--data.test_h", "24",
            "--data.test_w", "32", "--render.tile_size", "16",
            "--render.n_gaussians", "128"]
    for platform in ("cuda", "cpu"):
        blend.blend_sorted.launches = 0
        main(argv + _tiny(tmp_path, "av", platform))
        if platform == "cuda":
            assert blend.blend_sorted.launches == 4
    assert len(frames["cuda"]) == len(frames["cpu"]) == 4
    for a, b in zip(frames["cuda"], frames["cpu"]):
        assert a.shape == b.shape == (24, 32, 3)
        assert float(np.abs(a - b).max()) <= TOL_B2
    assert max(float(np.ptp(f)) for f in frames["cpu"]) > 0.05

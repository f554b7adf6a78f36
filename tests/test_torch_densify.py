"""Parity of the port's densification against the JAX package, on the CPU:
``allocate_slots`` bit for bit, ``densify_avatar`` with the JAX key's two
normal draws handed to the port, ``decode_opacities``, ``reset_opt_slots``
against optax's Adam state, and ``gs_trainer.densify`` end to end on the
tiny avatar (carried over by ``convert.avatar_state_from_numpy``).

Masks and integer fields must be equal; floats agree within 1e-6 (the same
float32 formulas in two libraries), the MLP-decoded opacities within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dreamwaltz_g_tpu import tests_support as jts
from dreamwaltz_g_tpu.configs import RenderConfig as JRenderConfig
from dreamwaltz_g_tpu.gaussian import densify as JD
from dreamwaltz_g_tpu.nerf.encoder import TriplaneConfig as JTriplane
from dreamwaltz_g_tpu.system import avatar as JA
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu.training import optim as JO
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.configs import RenderConfig
from dreamwaltz_g_tpu_torch.convert import avatar_state_from_numpy
from dreamwaltz_g_tpu_torch.gaussian import densify as TD
from dreamwaltz_g_tpu_torch.system import avatar as TA
from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
from dreamwaltz_g_tpu_torch.training import optim as TO
import tests.torch_threads  # noqa: F401  (per-worker threads)

TOL = 1e-6
PER_SLOT = ("positions", "log_scales", "quats", "lbs_weights")


def _masks(case, C=96):
    rng = np.random.default_rng(11)
    if case == "more_need_than_free":
        alive = rng.uniform(size=C) < 0.9
        need = alive & (rng.uniform(size=C) < 0.7)
    elif case == "none_free":
        alive = np.ones(C, bool)
        need = rng.uniform(size=C) < 0.3
    elif case == "none_needed":
        alive = rng.uniform(size=C) < 0.5
        need = np.zeros(C, bool)
    elif case == "all_free_all_need":
        alive = np.zeros(C, bool)
        need = np.ones(C, bool)
    else:
        rng = np.random.default_rng(case)
        alive = rng.uniform(size=C) < 0.6
        need = alive & (rng.uniform(size=C) < 0.4)
    return need, alive


@pytest.mark.parametrize("case", [0, 1, 2, "more_need_than_free",
                                  "none_free", "none_needed",
                                  "all_free_all_need"])
def test_allocate_slots_matches_jax_bit_for_bit(case):
    need, alive = _masks(case)
    jdest, jgranted = JD.allocate_slots(jnp.asarray(need), jnp.asarray(alive))
    dest, granted = TD.allocate_slots(torch.as_tensor(need),
                                      torch.as_tensor(alive))
    assert dest.dtype == torch.int32 and granted.dtype == torch.bool
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(granted.numpy(), np.asarray(jgranted))
    if case == "more_need_than_free":
        assert 0 < int(granted.sum()) < int(need.sum())
    if case == "none_free":
        assert int(granted.sum()) == 0 and (dest.numpy() == len(need)).all()


@pytest.fixture(scope="module")
def avatars():
    """The JAX tiny avatar with randomised per-slot parameters and
    statistics, and a function that makes its port twin."""
    jset = jts.tiny_avatar_setup(enc_cfg=JTriplane(resolution=16,
                                                   feature_dim=8))
    tset = tts.tiny_avatar_setup(device="cpu")
    st = jset.state
    C = st.capacity
    rng = np.random.default_rng(5)
    f32 = np.float32
    # scales on both sides of percent_dense = 0.01, real rotations, some
    # dead slots inside the live range and live ones past it
    alive = np.asarray(st.alive).copy()
    alive[rng.choice(64, 10, replace=False)] = False
    alive[64 + rng.choice(64, 12, replace=False)] = True
    denom = rng.integers(0, 4, size=C).astype(f32)
    p = st.params._replace(
        positions=jnp.asarray(rng.normal(size=(C, 3)).astype(f32) * 0.2),
        log_scales=jnp.asarray(np.log(10 ** rng.uniform(-3, -1, size=(C, 3))
                                      ).astype(f32)),
        quats=jnp.asarray(rng.normal(size=(C, 4)).astype(f32)),
        lbs_weights=jnp.asarray(rng.dirichlet(np.ones(6), size=C
                                              ).astype(f32)))
    st = st._replace(
        params=p, alive=jnp.asarray(alive),
        grad_accum=jnp.asarray((rng.uniform(0, 400, size=C) * denom
                                ).astype(f32)),
        grad_denom=jnp.asarray(denom),
        max_radii=jnp.asarray(rng.uniform(0, 40, size=C).astype(f32)),
        vertex_indices=jnp.asarray(rng.integers(0, 120, size=C)
                                   .astype(np.int32)))

    def twin(state=st):
        return avatar_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, state), tset.model,
            device="cpu")

    return jset, tset, st, twin


def _jax_offsets(key, C):
    k1, k2 = jax.random.split(key)
    return tuple(np.array(jax.random.normal(k, (C, 3))) for k in (k1, k2))


def _same_state(tstate, jstate, written, jwritten):
    np.testing.assert_array_equal(tstate.alive.numpy(),
                                  np.asarray(jstate.alive))
    np.testing.assert_array_equal(written.numpy(), np.asarray(jwritten))
    if jstate.vertex_indices is None:
        assert tstate.vertex_indices is None
    else:
        np.testing.assert_array_equal(tstate.vertex_indices.numpy(),
                                      np.asarray(jstate.vertex_indices))
    for name in PER_SLOT:
        np.testing.assert_allclose(
            getattr(tstate.params, name).detach().numpy(),
            np.asarray(getattr(jstate.params, name)), rtol=TOL, atol=TOL,
            err_msg=name)
    for name in ("grad_accum", "grad_denom", "max_radii"):
        assert float(getattr(tstate, name).abs().max()) == 0.0
        assert float(np.abs(np.asarray(getattr(jstate, name))).max()) == 0.0


@pytest.mark.parametrize("name,cfg,opac,vidx", [
    ("defaults", {}, False, True),
    ("clone_only", dict(enable_split=False), False, True),
    ("split_only", dict(enable_clone=False), False, True),
    ("prune_opacity", dict(min_opacity=0.3), True, True),
    ("prune_screen", dict(max_screen_size=20.0), False, True),
    ("prune_world", dict(max_world_size=0.05), False, True),
    ("no_prune", dict(enable_prune=False, max_screen_size=20.0), True, True),
    ("grad_prune", dict(grad_prune=True), False, True),
    ("more_need_than_free", dict(grad_threshold=1.0), False, True),
    ("no_vertex_indices", dict(max_world_size=0.05), True, False),
])
def test_densify_avatar_matches_jax(avatars, name, cfg, opac, vidx):
    jset, tset, st, twin = avatars
    if not vidx:
        st = st._replace(vertex_indices=None)
    C = st.capacity
    if name == "more_need_than_free":
        st = st._replace(alive=jnp.arange(C) < C - 5)
    key = jax.random.PRNGKey(3)
    op = np.random.default_rng(8).uniform(size=C).astype(np.float32) \
        if opac else None
    jnew, jwritten = JA.densify_avatar(
        st, JD.DensifyConfig(**cfg), key,
        opacities=None if op is None else jnp.asarray(op))
    tstate = twin(st)
    before = {n: getattr(tstate.params, n) for n in PER_SLOT}
    tnew, written = TA.densify_avatar(
        tstate, TD.DensifyConfig(**cfg),
        opacities=None if op is None else torch.as_tensor(op),
        offsets=_jax_offsets(key, C))
    _same_state(tnew, jnew, written, jwritten)
    # written in place: the optimizer's leaves are the same tensors
    for n in PER_SLOT:
        assert getattr(tnew.params, n) is before[n]
    grew = int(tnew.alive.sum()) - int(np.asarray(st.alive).sum())
    if name in ("defaults", "clone_only", "split_only"):
        assert grew > 0
    if name == "grad_prune" or name.startswith("prune"):
        # a live slot lost its alive bit and no child took it
        assert bool((torch.as_tensor(np.array(st.alive))
                     & ~tnew.alive).any())
    if name == "more_need_than_free":
        assert int(tnew.alive.sum()) == C        # every free slot was taken


def test_densify_avatar_draws_from_generator(avatars):
    """Without ``offsets`` the split's draws come from ``generator``: the
    same seed gives the same children, and the masks do not depend on the
    draws."""
    _, _, st, twin = avatars
    cfg = TD.DensifyConfig()
    runs = []
    for seed in (0, 0, 1):
        new, written = TA.densify_avatar(
            twin(), cfg, generator=torch.Generator().manual_seed(seed))
        runs.append((new.params.positions.detach().clone(), new.alive,
                     written))
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    assert float((runs[0][0] - runs[2][0]).abs().max()) > 0
    assert bool((runs[0][1] == runs[2][1]).all())
    assert bool((runs[0][2] == runs[2][2]).all())
    with pytest.raises(ValueError, match="generator"):
        TA.densify_avatar(twin(), cfg)


def test_decode_opacities_matches_jax(avatars):
    jset, tset, st, twin = avatars
    jop = JA.decode_opacities(jset.model, st)
    top = TA.decode_opacities(tset.model, twin())
    assert top.shape == (st.capacity,) and not top.requires_grad
    np.testing.assert_allclose(top.numpy(), np.asarray(jop), rtol=1e-5,
                               atol=1e-5)


def _grads_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.normal(size=np.shape(x)).astype(np.float32), tree)


def _set_torch_grads(state, model, g):
    p = state.params
    for name in PER_SLOT + ("extra_betas",):
        getattr(p, name).grad = torch.as_tensor(np.asarray(getattr(g, name)))
    p.encoder.planes.grad = torch.as_tensor(np.asarray(g.encoder.planes))
    for k, mp in p.mesh.items():
        for f in mp._fields:
            getattr(mp, f).grad = torch.as_tensor(
                np.asarray(getattr(g.mesh[k], f)))
    for net, tree in ((model.color_mlp, g.color_mlp),
                      (model.sq_net, g.sq_net)):
        for lname, leaf in tree["params"].items():
            lin = getattr(net, lname)
            lin.weight.grad = torch.as_tensor(
                np.asarray(leaf["kernel"])).T.contiguous()
            lin.bias.grad = torch.as_tensor(np.asarray(leaf["bias"]))


def _optax_moments(jopt, label, field):
    adam = next(s for s in jopt.inner_states[label].inner_state
                if isinstance(s, optax.ScaleByAdamState))
    return (np.asarray(getattr(adam.mu, field)),
            np.asarray(getattr(adam.nu, field)))


_MOMENTS = (("pos", "positions"), ("scale", "log_scales"),
            ("quat", "quats"))


def _two_steps(avatars):
    """Two identical optimizer steps on fixed gradients in both packages."""
    jset, tset, st, twin = avatars
    tstate = twin()
    jparams = st.params
    jtx = JO.build_avatar_optimizer(JRenderConfig(), 100)
    jopt = jtx.init(jparams)
    ttrain = TG.init_avatar_train_state(
        tstate, TO.build_avatar_optimizer(RenderConfig(), 100), tset.model)
    for step in range(2):
        g = _grads_like(jparams, seed=step)
        upd, jopt = jtx.update(g, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        _set_torch_grads(ttrain.avatar, tset.model, g)
        with torch.no_grad():
            ttrain.opt_state.step()
    return jtx, jopt, st._replace(params=jparams), ttrain


def _moments_match(ttrain, jopt):
    adam = ttrain.opt_state.adam
    for label, field in _MOMENTS:
        mu, nu = _optax_moments(jopt, label, field)
        st = adam.state[getattr(ttrain.avatar.params, field)]
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu, rtol=TOL,
                                   atol=TOL, err_msg=field)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu, rtol=TOL,
                                   atol=TOL, err_msg=field)


def test_reset_opt_slots_matches_optax(avatars):
    """After two identical steps, the moments of the written slots are zero
    and the rest untouched, equal to ``reset_opt_slots`` on optax's Adam
    state; a tensor without a capacity-long leading dimension keeps its
    moments; an optimizer that has not stepped yet has nothing to reset."""
    jset, tset, st, twin = avatars
    fresh = TG.init_avatar_train_state(
        twin(), TO.build_avatar_optimizer(RenderConfig(), 100), tset.model)
    C = st.capacity
    written = np.random.default_rng(2).uniform(size=C) < 0.3
    TD.reset_opt_slots(fresh.opt_state, torch.as_tensor(written))
    assert not fresh.opt_state.adam.state          # lazily created: empty

    jtx, jopt, jstate, ttrain = _two_steps(avatars)
    _moments_match(ttrain, jopt)
    adam = ttrain.opt_state.adam
    planes = ttrain.avatar.params.encoder.planes
    keep = {k: adam.state[planes][k].clone()
            for k in ("exp_avg", "exp_avg_sq")}
    pos_before = adam.state[ttrain.avatar.params.positions][
        "exp_avg"].clone()
    jopt = JD.reset_opt_slots(jopt, jnp.asarray(written))
    out = TD.reset_opt_slots(ttrain.opt_state, torch.as_tensor(written))
    assert out is ttrain.opt_state
    _moments_match(ttrain, jopt)
    w = torch.as_tensor(written)
    for _, field in _MOMENTS:
        st_ = adam.state[getattr(ttrain.avatar.params, field)]
        for k in ("exp_avg", "exp_avg_sq"):
            assert float(st_[k][w].abs().max()) == 0.0
            assert float(st_[k][~w].abs().min()) > 0.0
    torch.testing.assert_close(
        adam.state[ttrain.avatar.params.positions]["exp_avg"][~w],
        pos_before[~w], rtol=0, atol=0)
    for k, v in keep.items():
        torch.testing.assert_close(adam.state[planes][k], v, rtol=0, atol=0)


@pytest.mark.parametrize("with_model", [True, False])
def test_trainer_densify_matches_jax(avatars, with_model):
    """``gs_trainer.densify`` end to end: the new avatar, the reset moments
    and the parameters after one more optimizer step."""
    jset, tset, st, twin = avatars
    jtx, jopt, jstate, ttrain = _two_steps(avatars)
    # the statistics the densifier reads survive the optimizer steps
    ttrain = ttrain._replace(avatar=ttrain.avatar._replace(
        grad_accum=torch.as_tensor(np.array(st.grad_accum)),
        grad_denom=torch.as_tensor(np.array(st.grad_denom)),
        max_radii=torch.as_tensor(np.array(st.max_radii))))
    key = jax.random.PRNGKey(9)
    jtrain = JG.AvatarTrainState(jstate, jopt, jnp.asarray(2, jnp.int32))
    # a threshold inside the decoded opacities' range, so the prune acts
    cfg = dict(max_screen_size=30.0, min_opacity=float(np.median(
        np.asarray(JA.decode_opacities(jset.model, jstate)))))
    jnew = JG.densify(jtrain, JD.DensifyConfig(**cfg), key,
                      model=jset.model if with_model else None)
    tnew = TG.densify(ttrain, TD.DensifyConfig(**cfg),
                      model=tset.model if with_model else None,
                      offsets=_jax_offsets(key, st.capacity))
    assert tnew.step == ttrain.step and tnew.opt_state is ttrain.opt_state
    np.testing.assert_array_equal(tnew.avatar.alive.numpy(),
                                  np.asarray(jnew.avatar.alive))
    np.testing.assert_array_equal(tnew.avatar.vertex_indices.numpy(),
                                  np.asarray(jnew.avatar.vertex_indices))
    for name in PER_SLOT:
        np.testing.assert_allclose(
            getattr(tnew.avatar.params, name).detach().numpy(),
            np.asarray(getattr(jnew.avatar.params, name)), rtol=TOL,
            atol=TOL, err_msg=name)
    _moments_match(tnew, jnew.opt_state)
    if with_model:   # the decoded-opacity prune took slots of its own
        bare = JG.densify(jtrain, JD.DensifyConfig(**cfg), key)
        assert int(np.asarray(bare.avatar.alive).sum()) \
            != int(np.asarray(jnew.avatar.alive).sum())
    # one more step from the reset state lands on the same parameters
    g = _grads_like(jnew.avatar.params, seed=7)
    upd, _ = jtx.update(g, jnew.opt_state, jnew.avatar.params)
    jparams = optax.apply_updates(jnew.avatar.params, upd)
    _set_torch_grads(tnew.avatar, tset.model, g)
    with torch.no_grad():
        tnew.opt_state.step()
    for name in ("positions", "log_scales"):
        np.testing.assert_allclose(
            getattr(tnew.avatar.params, name).detach().numpy(),
            np.asarray(getattr(jparams, name)), rtol=TOL, atol=TOL,
            err_msg=name)

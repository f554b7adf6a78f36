"""The port's pipeline scripts (``dreamwaltz_g_tpu_torch/scripts/*.sh``)
against the JAX package's ``scripts/*.sh``, on the CPU without training.

Each pair runs under ``bash`` with the same arguments, the same environment
and a ``python`` that only records its command lines
(``dreamwaltz_g_tpu_torch.scripts.record``). The twin makes as many CLI
calls as the JAX script, each argv after ``-m dreamwaltz_g_tpu_torch.main``
equal to the JAX one after ``main.py``, argument for argument, and the
port's ``parse_args`` gives the JAX package's config on each. For the asset
runbook this covers its steps 3-4, the CLI calls; its step 1 differs by
design (the port reads the diffusers directory as it is).
"""
from pathlib import Path

import pytest

from dreamwaltz_g_tpu.configs import parse_args as jparse
from dreamwaltz_g_tpu.configs import to_dict as jto_dict
from dreamwaltz_g_tpu_torch.configs import parse_args, to_dict
from dreamwaltz_g_tpu_torch.scripts.record import (
    MODULE,
    REPO_ROOT,
    SCRIPTS,
    main_calls,
    record_calls,
)
import tests.torch_threads  # noqa: F401  (per-worker threads)

TEXT = "A Wizard in a Blue Robe"
CASES = {
    "train_w_expr": (TEXT,),
    "train_wo_expr": (TEXT,),
    "pretrain_nerf": (),
    "inference_aist": ("wizard/3dgs",),
    "inference_canonical": ("wizard/3dgs",),
    "inference_reenact": ("wizard/3dgs", "dance_0001"),
    "inference_talkshow": ("wizard/3dgs",),
    "inference_tram": ("wizard/3dgs", "clip_07"),
    "convert_all": (),
}
# the CLI calls each JAX script makes
CALLS = {"train_w_expr": 6, "train_wo_expr": 6, "pretrain_nerf": 1,
         "convert_all": 3}


def _runbook_env(tmp_path):
    """A model directory that both runbooks' first steps accept: the
    diffusers folders the port reads, with the flat tokenizer files the
    JAX runbook copies."""
    src = tmp_path / "hf"
    for d in ("unet", "vae", "text_encoder", "tokenizer", "controlnet_pose"):
        (src / d).mkdir(parents=True)
    for f in ("vocab.json", "merges.txt"):
        (src / "tokenizer" / f).write_text("{}")
        (src / f).write_text("{}")
    return {"HF_SRC": str(src), "EXTERNAL": str(tmp_path / "external")}


def test_every_jax_script_has_a_twin():
    jax = {p.stem for p in (REPO_ROOT / "scripts").glob("*.sh")}
    assert jax == set(CASES)
    assert {p.stem for p in SCRIPTS.glob("*.sh")} == set(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_makes_the_jax_scripts_calls(name, tmp_path):
    env = _runbook_env(tmp_path) if name == "convert_all" else None
    jax_calls = [c[1:] for c in record_calls(
        REPO_ROOT / "scripts" / f"{name}.sh", *CASES[name], env=env)
        if c[:1] == ["main.py"]]
    twin_raw = record_calls(SCRIPTS / f"{name}.sh", *CASES[name], env=env)
    twin_calls = [c[len(MODULE):] for c in twin_raw]
    # the twin calls nothing but the port's CLI
    assert all(c[:len(MODULE)] == MODULE for c in twin_raw)
    assert twin_calls == main_calls(f"{name}.sh", *CASES[name], env=env)
    assert len(jax_calls) == CALLS.get(name, 1)
    assert len(twin_calls) == len(jax_calls)
    for twin, jax in zip(twin_calls, jax_calls):
        assert twin == jax
        assert to_dict(parse_args(twin)) == jto_dict(jparse(jax))


def test_runbook_links_the_model_directory(tmp_path):
    env = _runbook_env(tmp_path)
    (Path(env["HF_SRC"]) / "clip_retrieval").mkdir()
    record_calls(SCRIPTS / "convert_all.sh", env=env)
    out = Path(env["EXTERNAL"]) / "guidance_diffusers"
    assert out.is_symlink() and out.resolve() == Path(env["HF_SRC"]).resolve()
    assert (out / "controlnet_pose").is_dir()
    assert (out / "clip_retrieval").is_dir()
    # a second run keeps the link
    record_calls(SCRIPTS / "convert_all.sh", env=env)
    assert out.resolve() == Path(env["HF_SRC"]).resolve()


@pytest.mark.parametrize("missing", ["controlnet_pose", "tokenizer"])
def test_runbook_refuses_an_incomplete_directory(tmp_path, missing):
    import shutil
    import subprocess

    env = _runbook_env(tmp_path)
    shutil.rmtree(Path(env["HF_SRC"]) / missing)
    with pytest.raises(subprocess.CalledProcessError):
        record_calls(SCRIPTS / "convert_all.sh", env=env)
    assert not (Path(env["EXTERNAL"]) / "guidance_diffusers").exists()

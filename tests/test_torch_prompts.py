"""The multi-prompt batch mode of the port against the JAX package, on the
CPU: ``configs/prompts.py``'s named sets, slices and ``.txt`` files, and
``main.run_multiple``'s experiment names.

Tolerances: none; the prompt lists, slugs and experiment names are equal.
The port's ``run_multiple`` differs from the JAX one by design in one way:
a failed prompt does not stop the batch in either, but the port raises one
``RuntimeError`` after the last prompt, naming every prompt that failed
and chained to the first failure, where the JAX loop prints and carries
on.
"""
import importlib.util
from pathlib import Path

import pytest

from dreamwaltz_g_tpu.configs import parse_args as jparse
from dreamwaltz_g_tpu.configs import prompts as JP
from dreamwaltz_g_tpu_torch import main as TM
from dreamwaltz_g_tpu_torch.configs import parse_args
from dreamwaltz_g_tpu_torch.configs import prompts as TP

ROOT = Path(__file__).resolve().parents[1]


def _jax_main():
    """The JAX package's ``main.py`` (the repo root's), loaded by path."""
    spec = importlib.util.spec_from_file_location("jax_main",
                                                  ROOT / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(JP.PROMPT_SETS))
def test_named_sets_match_jax(name):
    assert TP.get_avatar_list(name) == JP.get_avatar_list(name)
    assert TP.PROMPT_SETS[name] == JP.PROMPT_SETS[name]


@pytest.mark.parametrize("spec", ["demo,2-5", "characters,10-12",
                                  "eval,3", "diverse,30-99"])
def test_slices_match_jax(spec):
    got = TP.get_avatar_list(spec)
    assert got == JP.get_avatar_list(spec) and got


def test_txt_file_matches_jax(tmp_path):
    p = tmp_path / "mine.txt"
    p.write_text("# my avatars\n"
                 "a knight in shining armor,\n"
                 "\n"
                 "A Wizard!  with a hat.\r\n"
                 "  a dancer in red  \n")
    for spec in (str(p), f"{p},2-3"):
        got = TP.get_avatar_list(spec)
        assert got == JP.get_avatar_list(spec) and got
    assert [t for _, t in TP.get_avatar_list(str(p))] == [
        "a knight in shining armor", "A Wizard!  with a hat",
        "a dancer in red"]
    assert TP.read_txt_file(str(p)) == JP.read_txt_file(str(p))


@pytest.mark.parametrize("exp_name", ["batch/@/nerf", "batch"])
def test_run_multiple_names_match_jax(monkeypatch, exp_name):
    """Each prompt's text and experiment name ('@' replaced by its slug,
    else the slug appended) as the JAX ``run_multiple`` gives them."""
    argv = ["--guide.text_set", "demo,3-5", "--log.exp_name", exp_name]
    jm = _jax_main()
    jruns, truns = [], []
    monkeypatch.setattr(jm, "run", lambda c: jruns.append(
        (c.guide.text, c.log.exp_name)))
    monkeypatch.setattr(TM, "run", lambda c: truns.append(
        (c.guide.text, c.log.exp_name)) or c.log.exp_name)
    jm.run_multiple(jparse(argv))
    cfg = parse_args(argv)
    got = TM.run_multiple(cfg)
    assert truns == jruns and len(truns) == 3
    assert got == [n for _, n in truns]
    # the caller's config is left as it was
    assert cfg.log.exp_name == exp_name and cfg.guide.text == ""


def test_run_multiple_raises_after_the_batch(monkeypatch):
    """A failed prompt does not stop the batch; after the last one, one
    error names every failure, chained to the first."""
    seen = []

    def run(c):
        seen.append(c.guide.text)
        if len(seen) in (1, 3):
            raise ValueError(f"failure {len(seen)}")
        return c.guide.text

    monkeypatch.setattr(TM, "run", run)
    with pytest.raises(RuntimeError, match="2 prompt") as e:
        TM.main(["--guide.text_set", "demo,1-4"])
    texts = [t for _, t in TP.get_avatar_list("demo,1-4")]
    assert seen == texts
    assert repr(texts[0]) in str(e.value) and repr(texts[2]) in str(e.value)
    assert repr(texts[1]) not in str(e.value)
    assert isinstance(e.value.__cause__, ValueError)
    assert str(e.value.__cause__) == "failure 1"
    monkeypatch.setattr(TM, "run", lambda c: c.guide.text)
    assert TM.main(["--guide.text_set", "demo,1-4"]) == texts

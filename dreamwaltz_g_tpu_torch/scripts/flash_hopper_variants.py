"""Where the Hopper flash forward's time goes: variants of
``csrc/flash_fwd_hopper.cu`` built side by side and timed in turns.

Each variant is the tree's source with one edit, compiled by its own
``nvcc`` into a library under ``--build`` and called through the same C
interface as ``guidance/flash.py:flash_fwd_hopper``. Some variants drop
work and compute wrong values: they say what the rest costs, and only
their times are read.

* ``tree``: the source as it stands;
* ``split_pv``: P V split around the exponentials at every width (P V's
  first four k-steps issued once the first half of the tile's
  exponentials is done, the second half computed while they run, then
  the other four); the same values;
* ``no_exp``: each probability's ``ex2`` replaced by its argument (no work
  on the special-function units);
* ``no_pv``: O += P V not issued;
* ``no_softmax``: the softmax replaced by P = S rounded to bf16 (no
  maxima, no exponentials; the row sums stay);
* ``no_loads``: the producer copies the first ring's tiles only and then
  completes the barriers without copies (no K / V traffic);
* ``no_loads_no_softmax``: both;
* ``one_tile``: every block walks its first key tile only (the
  prologue, one tile and the epilogue: with the tree's time at the same
  grid, what a block's set-up costs beside its loop).

``--source PATH`` adds another source (an older checkout's
``flash_fwd_hopper.cu``) as ``other``, built and timed the same way at
the widths it takes. The time of a call is the launch median of the
kernel alone over 20 calls by ``torch.profiler`` (as
``chip_smoke.py:kernel_device_ms``), after one untimed call (a session
that records no device time runs again, up to three, then the script
raises), and the variants run in the order given, then the library call
(``scaled_dot_product_attention``) and ``csrc/flash_attn.cu``'s
row-split forward at the same width (``rows``), then the variants again
in reverse. Each variant is first held against the plain version at
``HELD`` (a one-tile call and a full one at each of D = 40 and 80, and
one at D = 64): the largest error in units of the per-element limit 2^-9
(sum_j p_j |v_j| + |out|), and the lse's largest error. Card only:

    python -m dreamwaltz_g_tpu_torch.scripts.flash_hopper_variants \\
        [--variants tree,no_exp] [--source PATH]

One JSON line a build, a held shape and a timed shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from .. import kernels
from ..guidance import flash as FL

SOURCE = kernels.CSRC / "flash_fwd_hopper.cu"
SHAPES = ((2, 4096, 8, 40), (8, 4096, 8, 40), (1, 4096, 8, 40),
          (2, 4096, 4, 40), (2, 4096, 10, 64), (2, 1024, 20, 64),
          (2, 9216, 5, 64), (2, 2304, 10, 64), (2, 1024, 8, 80),
          (8, 1024, 8, 80), (1, 1024, 8, 80), (2, 1024, 4, 80))
HELD = ((2, 128, 3, 40), (2, 4096, 8, 40), (2, 128, 3, 80),
        (2, 1024, 8, 80), (2, 1024, 20, 64))

_MAX = "    tile_max(s, m, alpha, neg_m, scale_log2);\n"
# no_softmax: P = S rounded to bf16, no maxima and no exponentials (the
# row sums stay)
_NO_MAX = "    alpha[0] = alpha[1] = 1.f;\n    neg_m[0] = neg_m[1] = 0.f;\n"
_EXPS = ("ex2(fmaf(s[4 * j], scale_log2, neg_m[0]))",
         "ex2(fmaf(s[4 * j + 1], scale_log2, neg_m[0]))",
         "ex2(fmaf(s[4 * j + 2], scale_log2, neg_m[1]))",
         "ex2(fmaf(s[4 * j + 3], scale_log2, neg_m[1]))")
_LOADS = '''    load(r.k(s), mp.k, r.k_full(s), i * BN);
    load(r.v(s), mp.v, r.v_full(s), i * BN);
'''


def _edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"the source lacks {old!r}")
    return text.replace(old, new, 1)


def _no_softmax(text: str) -> str:
    text = _edit(text, _MAX, _NO_MAX)
    for e in _EXPS:
        text = _edit(text, e, e[len("ex2(fmaf("):e.index(",")])
    return text


def variant(name: str, text: str) -> str:
    """The source ``text`` with variant ``name``'s edit."""
    if name in ("tree", "other"):
        return text
    if name == "split_pv":
        return _edit(text, "bool split_pv() {\n  return false;",
                     "bool split_pv() {\n  return true;")
    if name == "no_exp":
        for r in range(4):
            text = _edit(text, f"    float p{r} = ex2(fmaf(",
                         f"    float p{r} = (fmaf(")
        return text
    if name == "no_pv":
        return _edit(text, "  for (int kk = K0; kk < K1; ++kk)\n",
                     "  for (int kk = K0; kk < K0; ++kk)\n")
    if name == "no_softmax":
        return _no_softmax(text)
    if name.startswith("no_loads"):
        text = _edit(text, _LOADS, "    if (i < STAGES) {\n" + _LOADS
                     + "    } else {\n      mbar_arrive(r.k_full(s));\n"
                     "      mbar_arrive(r.v_full(s));\n    }\n")
        if name == "no_loads_no_softmax":
            text = _no_softmax(text)
        return text
    if name == "one_tile":
        return _edit(text, "  const int n_tiles = N / BN;\n",
                     "  const int n_tiles = 1;\n")
    raise ValueError(f"no variant {name!r}")


VARIANTS = ("tree", "split_pv", "no_exp", "no_pv", "no_softmax",
            "no_loads", "no_loads_no_softmax", "one_tile")


def build(sources: dict, out_dir: Path) -> dict:
    """{name: the launch function} of each source that builds, one
    ``nvcc`` each, all started together; a JSON line a build (ptxas's
    registers and spills by entry function, or the compiler's errors)."""
    procs = {}
    for name, text in sources.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_fwd_hopper.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "flash_fwd_hopper.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        print(json.dumps(dict(
            phase="build", variant=name, rc=proc.returncode,
            log=[ln.strip() for ln in log.splitlines()
                 if any(w in ln for w in ("entry function", "registers",
                                          "spill", "C7513", "error"))])),
            flush=True)
        if proc.returncode:
            continue
        fn = ctypes.CDLL(str(out_dir / name / "lib.so")).flash_fwd_hopper
        fn.argtypes = kernels.SIGNATURES["flash_fwd_hopper"][
            "flash_fwd_hopper"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


#: the C function's code for a width or view it does not take
BAD_SHAPE = 100001


def call(fn, q, k, v):
    """(out, lse) of one launch, or None where the source does not take
    the width (an older source at D = 40 or 80)."""
    B, N, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, N, H, D, *FL._strides(q, k, v),
            torch.cuda.current_stream().cuda_stream)
    if rc == BAD_SHAPE:
        return None
    if rc != 0:
        raise RuntimeError(f"flash_fwd_hopper variant: CUDA error {rc}")
    return out, lse


def launch_median_ms(fn, what: str, reps: int = 20, tries: int = 3):
    """The kernels one ``fn()`` launches, alone: the sum over kernels of
    the median of their launches' device times over ``reps`` calls; a
    session in which the profiler recorded no device time is run again,
    up to ``tries`` sessions, and then ``what`` is named in the error."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                times.setdefault(e.key, []).append(
                    e.device_time_total / 1e3)
        if times:
            return sum(statistics.median(t) for t in times.values())
    raise RuntimeError(f"{what}: the profiler recorded no device time in "
                       f"{tries} sessions")


def inputs(shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--source", default=None,
                    help="another flash_fwd_hopper.cu, timed as 'other'")
    ap.add_argument("--build", default=str(kernels.BUILD_DIR / "variants"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_hopper_variants: needs a CUDA card")
    text = SOURCE.read_text()
    sources = {n: variant(n, text) for n in args.variants.split(",")}
    if args.source:
        sources["other"] = Path(args.source).read_text()
    fns = build(sources, Path(args.build))
    names = list(fns)
    for shape in HELD:
        q, k, v = inputs(shape, sum(shape))
        ref, ref_lse = FL.flash_attention_plain(q.float(), k.float(),
                                                v.float())
        tol = 2.0 ** -9 * (FL.flash_attention_plain(
            q.float(), k.float(), v.float().abs())[0] + ref.abs())
        held = {}
        for name in names:
            got = call(fns[name], q, k, v)
            torch.cuda.synchronize()
            if got is None:
                continue
            out, lse = got
            held[name] = dict(
                out_of_limit=float(((out.float() - ref).abs() / tol).max()),
                lse_err=float((lse - ref_lse).abs().max()))
        print(json.dumps(dict(phase="held", shape=shape, **held)),
              flush=True)
    for shape in SHAPES:
        q, k, v = inputs(shape, 7)
        row = dict(phase="time", shape=shape)
        taken = [n for n in names if call(fns[n], q, k, v) is not None]
        for name in taken + ["library", "rows"] + taken[::-1]:
            if name == "library":
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                fn = (lambda: torch.nn.functional.
                      scaled_dot_product_attention(qt, kt, vt))
            elif name == "rows":
                fn = (lambda: FL._fwd_flash_attn(q, k, v, q.device))
            else:
                fn = (lambda f=fns[name]: call(f, q, k, v))
            row.setdefault(name, []).append(
                launch_median_ms(fn, f"{name} at {shape}"))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Where the Hopper flash forward's time goes: variants of
``csrc/flash_fwd_hopper.cu`` built side by side and timed in turns.

Each variant is the tree's source with one edit, compiled by its own
``nvcc`` into a library under ``--build`` and called through the same C
interface as ``guidance/flash.py:flash_fwd_hopper``. Some variants drop
work and compute wrong values: they say what the rest costs, and only
their times are read.

* ``tree``: the source as it stands;
* ``pingpong``: the two consumer warpgroups' softmax phases alternate on
  named barriers (one's products under the other's exponentials);
* ``stages_swapped``: the K / V ring's stages swapped between the widths
  (2 at D = 40, 3 at D = 64);
* ``split_pv``: P V's first four k-steps issued once the first half of
  the tile's exponentials is done, the second half computed while they
  run, then the other four;
* ``no_exp``: each probability's ``ex2`` replaced by its argument (no work
  on the special-function units);
* ``no_pv``: O += P V not issued;
* ``no_softmax``: the softmax replaced by P = S rounded to bf16;
* ``no_loads``: the producer copies the first ring's tiles only and then
  completes the barriers without copies (no K / V traffic);
* ``no_loads_no_softmax``: both.

``--source PATH`` adds another source (an older checkout's
``flash_fwd_hopper.cu``) as ``other``, built and timed the same way at
the widths it takes. The
time of a call is the launch median of the kernel alone over 20 calls by
``torch.profiler`` (as ``chip_smoke.py:kernel_device_ms``), after one
untimed call, and the variants run in the order given, then the library
call (``scaled_dot_product_attention``), then the variants again in
reverse. Each variant is first held against the plain version at
(2, 128, 3, 40) and (2, 4096, 8, 40): the largest error in units of the
per-element limit 2^-9 (sum_j p_j |v_j| + |out|). Card only:

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
          (2, 9216, 5, 64), (2, 2304, 10, 64))

_RING = "template <int S>\nstruct Ring {"
_BARRIERS = '''__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");
}

''' + _RING
_SOFTMAX = "    softmax_tile(s, pa, m, l, alpha, scale_log2);\n"
_PLAIN_P = '''#pragma unroll
    for (int j = 0; j < 16; ++j) {
      pa[j / 2][2 * (j & 1)] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pa[j / 2][2 * (j & 1) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
    alpha[0] = alpha[1] = 1.f;
'''
_LOADS = '''    mbar_expect_tx(r.k_full(s), TILE);
    tma_load(r.k(s), tk, r.k_full(s), h, i * BN, b);
    mbar_expect_tx(r.v_full(s), TILE);
    tma_load(r.v(s), tv, r.v_full(s), h, i * BN, b);
'''
_LOOP = ("  mbar_wait(r.q_full(), 0);\n"
         "  for (int i = 0; i < n_tiles; ++i) {\n")
# split_pv: the softmax in two halves around P V's two halves
_SPLIT_FUNCS = '''// the tile's row maxima: m and -m in the log2 domain,
// alpha = 2^(m_old - m_new)
__device__ __forceinline__ void tile_max(const float (&s)[64], float (&m)[2],
                                         float (&alpha)[2],
                                         float (&neg_m)[2],
                                         float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
}

// P of keys 64 HALF .. 64 HALF + 63: P V's k-steps 4 HALF .. 4 HALF + 3
template <int HALF>
__device__ __forceinline__ void tile_exp(const float (&s)[64],
                                         uint32_t (&pa)[8][4],
                                         const float (&neg_m)[2],
                                         float (&sum)[2], float scale_log2) {
#pragma unroll
  for (int j = 8 * HALF; j < 8 * HALF + 8; ++j) {
    float p0 = ex2(fmaf(s[4 * j], scale_log2, neg_m[0]));
    float p1 = ex2(fmaf(s[4 * j + 1], scale_log2, neg_m[0]));
    float p2 = ex2(fmaf(s[4 * j + 2], scale_log2, neg_m[1]));
    float p3 = ex2(fmaf(s[4 * j + 3], scale_log2, neg_m[1]));
    sum[0] += p0 + p1;
    sum[1] += p2 + p3;
    pa[j / 2][2 * (j & 1)] = pack_bf16(p0, p1);
    pa[j / 2][2 * (j & 1) + 1] = pack_bf16(p2, p3);
  }
}

template <int HALF>
__device__ __forceinline__ void fence_half(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 4 * HALF; i < 4 * HALF + 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

'''

_TILE_LOOP = '''    fence_regs(s);
    softmax_tile(s, pa, m, l, alpha, scale_log2);
    rescale(o, alpha);
    mbar_wait(r.v_full(st), ph);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_pv(st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
'''

_SPLIT_LOOP = '''    fence_regs(s);
    float neg_m[2], sum[2] = {0.f, 0.f};
    tile_max(s, m, alpha, neg_m, scale_log2);
    tile_exp<0>(s, pa, neg_m, sum, scale_log2);
    rescale(o, alpha);
    mbar_wait(r.v_full(st), ph);
    fence_regs(o);
    fence_half<0>(pa);
    wgmma_fence();
    issue_pv_half(st, 0);
    wgmma_commit();
    tile_exp<1>(s, pa, neg_m, sum, scale_log2);
    fence_half<1>(pa);
    wgmma_fence();
    issue_pv_half(st, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + sum[rr];
'''

_ISSUE_PV = '''  auto issue_pv = [&](int stage) {
    const uint64_t dv = sw128_desc(r.v(stage));
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_pv(o, pa[kk], dv + (2048 >> 4) * kk);
  };'''

_SPLIT_PV = '''  auto issue_pv_half = [&](int stage, int half) {
    const uint64_t dv = sw128_desc(r.v(stage));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv(o, pa[4 * half + kk], dv + (2048 >> 4) * (4 * half + kk));
  };'''


def _edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"the source lacks {old!r}")
    return text.replace(old, new, 1)


def variant(name: str, text: str) -> str:
    """The source ``text`` with variant ``name``'s edit."""
    if name in ("tree", "other"):
        return text
    if name == "pingpong":
        text = _edit(text, _RING, _BARRIERS)
        text = _edit(text, _LOOP, "  if (c == 1) named_arrive(1);\n" + _LOOP)
        return _edit(text, _SOFTMAX, "    named_sync(1 + c);\n" + _SOFTMAX
                     + "    if (c == 0 || i + 1 < n_tiles) "
                     "named_arrive(2 - c);\n")
    if name == "stages_swapped":
        return _edit(text, "return HD == 40 ? 3 : 2;",
                     "return HD == 40 ? 2 : 3;")
    if name == "split_pv":
        start = text.find("__device__ __forceinline__ void softmax_tile(")
        end = text.find("template <int R>\n__device__ __forceinline__ "
                        "void rescale(")
        if start < 0 or end < start:
            raise ValueError("the source lacks softmax_tile before rescale")
        text = text[:start] + _SPLIT_FUNCS + text[end:]
        text = _edit(text, _TILE_LOOP, _SPLIT_LOOP)
        return _edit(text, _ISSUE_PV, _SPLIT_PV)
    if name == "no_exp":
        for r in range(4):
            text = _edit(text, f"    float p{r} = ex2(fmaf(",
                         f"    float p{r} = (fmaf(")
        return text
    if name == "no_pv":
        return _edit(text, "    issue_pv(st);\n", "")
    if name == "no_softmax":
        return _edit(text, _SOFTMAX, _PLAIN_P)
    if name.startswith("no_loads"):
        text = _edit(text, _LOADS, "    if (i < STAGES) {\n" + _LOADS
                     + "    } else {\n      mbar_arrive(r.k_full(s));\n"
                     "      mbar_arrive(r.v_full(s));\n    }\n")
        if name == "no_loads_no_softmax":
            text = _edit(text, _SOFTMAX, _PLAIN_P)
        return text
    raise ValueError(f"no variant {name!r}")


VARIANTS = ("tree", "pingpong", "stages_swapped", "split_pv", "no_exp",
            "no_pv", "no_softmax", "no_loads", "no_loads_no_softmax")


def build(sources: dict, out_dir: Path) -> dict:
    """{name: the launch function} of each source that builds, one
    ``nvcc`` each, all started together; a JSON line a build (its ptxas
    registers, or the compiler's errors)."""
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
                 if "registers" in ln or "C7513" in ln or "error" in ln])),
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
    the width (an older source at D = 40)."""
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


def launch_median_ms(fn, reps: int = 20) -> float:
    """The kernels one ``fn()`` launches, alone: the sum over kernels of
    the median of their launches' device times over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            times.setdefault(e.key, []).append(e.device_time_total / 1e3)
    if not times:
        raise RuntimeError("the profiler recorded no device time")
    return sum(statistics.median(t) for t in times.values())


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
    for shape in ((2, 128, 3, 40), (2, 4096, 8, 40)):
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
        for name in taken + ["library"] + taken[::-1]:
            if name == "library":
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                fn = (lambda: torch.nn.functional.
                      scaled_dot_product_attention(qt, kt, vt))
            else:
                fn = (lambda f=fns[name]: call(f, q, k, v))
            row.setdefault(name, []).append(launch_median_ms(fn))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

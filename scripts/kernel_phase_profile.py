"""Where a CTA of K3 (supertile table rounds) spends its time, and K3 / K4
times of other versions of their sources, on one CUDA card.

    python3 scripts/kernel_phase_profile.py [--k3 FILE ...] [--k4 FILE ...]
                                            [--sass DIR]

Builds chip_smoke.py's inputs: the first gated level of a real 272x480
pair-merge chunk for K3 (`supertile_level_inputs`) and a presmoothed
(21,272,480) chunk for K4.  For each K3 source (the package's
`csrc/tile_table.cu` first, then each --k3 file) it prints:
 - the kernel's time (launches back to back, `chip_smoke.device_ms`) and
   whether its labels equal `tile_table_rounds_plain`;
 - a phase profile from an instrumented copy: after every block barrier
   of the source (`__syncthreads`, `__syncthreads_or`) thread 0 of each
   CTA adds the clock64 cycles since the previous barrier to that
   barrier's counter; the script prints, per barrier, the mean cycles a
   CTA and the mean times a CTA passed it, in source order.  Thread 0's
   clock between two barriers is the phase's time: every thread waits at
   the barrier for the slowest;
 - the SASS count of shared-memory atomics and of compare-and-swap loops
   (`ATOMS.CAST.SPIN`), from cuobjdump where the toolkit has it.
For each K4 source (the package's `csrc/tile_preseg.cu`, then each --k4
file, with or without the per-tile iteration output) it prints the time
per chunk at 48 iterations and at 0 (what is not the flood itself), and
whether the raw roots equal `flood_plain`.

Sources under test are compiled with the package's nvcc flags into a
temporary directory; the package's own build is not touched.  With
--sass, each build's SASS (cuobjdump -sass) is written to DIR.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from video_segment_tpu_torch import _build  # noqa: E402
from video_segment_tpu_torch.ops import tile_preseg as tp  # noqa: E402
from video_segment_tpu_torch.ops import tile_table as tt  # noqa: E402

MAX_CTAS = 4096
MAX_MARKS = 32

_PROF_HEAD = f"""
__device__ unsigned long long vst_prof[{MAX_CTAS}][{MAX_MARKS}][2];
#define VST_MARK(n) do {{ if (threadIdx.x == 0) {{ \\
    const long long _t = clock64(); \\
    vst_prof[blockIdx.x][n][0] += _t - vst_last; \\
    vst_prof[blockIdx.x][n][1] += 1; vst_last = _t; }} }} while (0)
"""

_PROF_TAIL = """
extern "C" int vst_prof_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, vst_prof, sizeof(vst_prof));
}
extern "C" int vst_prof_clear() {
  static unsigned long long zero[sizeof(vst_prof) / 8];
  return (int)cudaMemcpyToSymbol(vst_prof, zero, sizeof(vst_prof));
}
"""


def instrument(src: str) -> tuple[str, list[str]]:
    """Insert a clock64 mark after every block barrier of the kernel;
    returns the source and each mark's barrier statement."""
    marks: list[str] = []
    out = []
    for line in src.splitlines():
        m = re.match(r"(\s*)if \(!__syncthreads_or\((\w+)\)\) break;", line)
        if m:
            ind, var = m.groups()
            out.append(f"{ind}{{ const bool _c = __syncthreads_or({var}); "
                       f"VST_MARK({len(marks)}); if (!_c) break; }}")
            marks.append(line.strip())
            continue
        out.append(line)
        if "__syncthreads" in line and line.rstrip().endswith(";"):
            ind = re.match(r"\s*", line).group(0)
            out.append(f"{ind}VST_MARK({len(marks)});")
            marks.append(line.strip())
        if "extern __shared__" in line:
            ind = re.match(r"\s*", line).group(0)
            out.append(f"{ind}long long vst_last = clock64();")
    body = "\n".join(out)
    body = body.replace("namespace {", _PROF_HEAD + "\nnamespace {", 1)
    return body + _PROF_TAIL, marks


SASS_DIR = None


def build(src_text: str, name: str, tmp: str) -> tuple[ctypes.CDLL, str]:
    path = os.path.join(tmp, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src_text)
    so = os.path.join(tmp, f"{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    regs = " | ".join(ln.strip() for ln in (proc.stdout + proc.stderr)
                      .splitlines() if "registers" in ln or "spill" in ln)
    if SASS_DIR:
        os.makedirs(SASS_DIR, exist_ok=True)
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        with open(os.path.join(SASS_DIR, f"{name}.sass"), "w") as f:
            subprocess.run([tool, "-sass", so], stdout=f, check=False)
    return ctypes.CDLL(so), regs


def sass_atomics(so: str) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "cuobjdump not found"
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True).stdout
    atoms = re.findall(r"\bATOMS\.[A-Z0-9_.]+", sass)
    counts: dict[str, int] = {}
    for a in atoms:
        counts[a] = counts.get(a, 0) + 1
    return f"shared atomics in SASS {counts or 'none'}"


def k3_call(lib, kw: dict):
    outr = torch.empty_like(kw["labr"])
    outc = torch.empty_like(kw["labc"])
    prm = tt._Params(theta=int(kw["theta"]), rounds=int(kw["rounds"]),
                     metric_l1=int(kw["metric"] == "l1"),
                     merge_threshold=float(kw["merge_threshold"]),
                     force_merge_weight=float(kw["force_merge_weight"]))
    n, sr, _ = kw["labr"].shape
    planes = [kw[k] for k in ("labr", "labc", "size", "c0", "c1", "c2",
                              "fin", "blocked")]
    err = lib.tile_table_launch(
        *(ctypes.c_void_p(x.data_ptr()) for x in planes),
        ctypes.c_void_p(kw["edges"].data_ptr()),
        ctypes.c_void_p(outr.data_ptr()), ctypes.c_void_p(outc.data_ptr()),
        n, sr, kw["edges"].shape[1], ctypes.byref(prm),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")
    return outr, outc


def profile_k3(name: str, src: str, kw: dict, want, tmp: str) -> None:
    lib, regs = build(src, f"k3_{name}", tmp)
    got = k3_call(lib, kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    ms = cs.device_ms(lambda: k3_call(lib, kw), 20)
    print(f"[k3 {name}] {ms:.4f} ms a launch; equal to plain: {same}; "
          f"{regs}; {sass_atomics(os.path.join(tmp, f'k3_{name}.so'))}",
          flush=True)
    ilib, _ = build(instrument(src)[0], f"k3_{name}_prof", tmp)
    marks = instrument(src)[1]
    ilib.vst_prof_clear()
    k3_call(ilib, kw)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (MAX_CTAS * MAX_MARKS * 2))()
    if ilib.vst_prof_read(buf):
        raise RuntimeError("reading the phase profile failed")
    n = kw["labr"].shape[0]
    prof = torch.tensor(list(buf), dtype=torch.float64).reshape(
        MAX_CTAS, MAX_MARKS, 2)[:n]
    cyc = prof[..., 0].mean(0)
    cnt = prof[..., 1].mean(0)
    total = float(cyc[:len(marks)].sum())
    for i, stmt in enumerate(marks):
        print(f"[k3 {name}] barrier {i} ({stmt}): {float(cyc[i]):.0f} "
              f"cycles a CTA ({100 * float(cyc[i]) / total:.1f}%), passed "
              f"{float(cnt[i]):.2f} times", flush=True)
    # chip_smoke.device_ms measured the clock64 rate with a sleep kernel.
    print(f"[k3 {name}] {total:.0f} cycles a CTA up to the last barrier = "
          f"{total / cs._cycles_per_ms * 1e3:.2f} us at "
          f"{cs._cycles_per_ms / 1e3:.0f} MHz", flush=True)


def k4_call(lib, vol, thr, iters, new_sig: bool):
    """One launch of a K4 build: the package's signature (a per-tile
    iteration output, the l2 key in place of the threshold) or the older
    one without either."""
    t, h, w, _ = vol.shape
    out = torch.empty((t, h, w), dtype=torch.int32, device=vol.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = [ctypes.c_void_p(vol.data_ptr()), ctypes.c_void_p(out.data_ptr())]
    if new_sig:
        args.append(ctypes.c_void_p(None))
    cmp = tp.flood_key(thr) if new_sig else thr
    err = lib.tile_preseg_launch(*args, t, h, w, ctypes.c_float(cmp), 0,
                                 iters, stream)
    if err:
        raise RuntimeError(f"K4 launch failed: CUDA error {err}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k3", nargs="*", default=[])
    ap.add_argument("--k4", nargs="*", default=[])
    ap.add_argument("--sass")
    args = ap.parse_args()
    global SASS_DIR
    SASS_DIR = args.sass
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from video_segment_tpu_torch.core import dense
    from video_segment_tpu_torch.core import oversegmentation as ov
    from video_segment_tpu_torch.ops import tile_felz as tf
    dev = torch.device("cuda", 0)
    frames = cs.synthetic_clip(21)
    vol = torch.stack([dense._preprocess_u8(torch.as_tensor(fr, device=dev),
                                            "bilateral") for fr in frames])
    p = ov.OversegParams()
    kw1 = dict(schedule=p.preseg_schedule,
               rounds_per_level=p.preseg_rounds_per_level,
               merge_threshold=p.merge_threshold, metric=p.metric,
               fin_margin=p.preseg_fin_margin, fin_eager=p.preseg_fin_eager,
               fin_gated=p.preseg_fin_gated, pair_merge=True)
    lab, fin, st = tf.tile_felzenszwalb(vol, **kw1)
    n_seeds = int((lab.reshape(-1) == torch.arange(lab.numel(),
                                                   device=dev)).sum())
    params = ov.OversegParams(
        preseg_pair_merge=True, st_levels=3, table_slots=min(
            -(-(n_seeds + 1024) // 16384) * 16384, lab.numel()))
    kw = ov.supertile_level_inputs(vol, lab, fin, st, params)
    want = tt.tile_table_rounds_plain(**kw)
    print(f"[k3] real chunk level 0: {tuple(kw['edges'].shape)} edges, "
          f"theta {kw['theta']}, rounds {kw['rounds']}; {cs.nvidia_smi()}",
          flush=True)
    sources = [("package", os.path.join(_build.CSRC, "tile_table.cu"))]
    sources += [(f"arg{i}", f) for i, f in enumerate(args.k3)]
    with tempfile.TemporaryDirectory() as tmp:
        for name, path in sources:
            with open(path) as f:
                profile_k3(name, f.read(), kw, want, tmp)
        thr = p.preseg_threshold
        raw = tp.flood_plain(vol, thr, "l2", 48)
        k4s = [("package", os.path.join(_build.CSRC, "tile_preseg.cu"))]
        k4s += [(f"arg{i}", f) for i, f in enumerate(args.k4)]
        for name, path in k4s:
            with open(path) as f:
                src = f.read()
            lib, regs = build(src, f"k4_{name}", tmp)
            new_sig = "tile_iters" in src
            got = k4_call(lib, vol, thr, 48, new_sig)
            torch.cuda.synchronize()
            ms = {n: cs.device_ms(lambda: k4_call(lib, vol, thr, n, new_sig),
                                  50) for n in (48, 0)}
            print(f"[k4 {name}] {ms[48]:.4f} ms a (21,272,480) chunk at 48 "
                  f"iterations, {ms[0]:.4f} ms at 0 (colours, edges and "
                  f"output alone); equal to plain: {torch.equal(got, raw)}; "
                  f"{regs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

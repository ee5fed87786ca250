"""Where the LSTM recurrence kernels (`csrc/lstm_scan.cu`) spend their time
on a CUDA card, phase by phase, with no profiler: variants of a checkout's
source are made by text substitution, built with the same nvcc flags as the
port, and loaded in place of the kernel library.

    python3 scripts/lstm_scan_phases.py [--kernel backward|forward] [--root CHECKOUT]
        [BATCH ...]   (default: backward, 16)

`--kernel` picks K3, the backward (default), or K2, the forward (K4 is the
same kernel without `cs`). `--root` names the checkout whose source and
wrapper are measured (default: this one), so a parent checkout unpacked
under `build/` can be measured with this script. The substitutions of each
known design of a kernel are kept below; the script takes the set whose
anchors the source holds:
- backward `unit_split` (the first design: one block per U units for
  all videos, the gates recomputed at every step, dW_hh accumulated in
  shared memory, two phases and a grid barrier a step);
- backward `carry_only` (the current design: the gates in a tiled product
  before the loop, a loop of video groups x unit slices that carries only dh
  and dc, dW_hh in a tiled product after it);
- forward `weight_stationary` (the current design: a grid of video
  groups x unit slices, the gate columns in shared memory, a barrier among a
  group's blocks a step, the group's h staged in chunks with cp.async).

Variants, each timed at every batch on both flagship layers (att_lstm,
H=256; video_lstm, H=512), on the inputs `chip_smoke.py` times the kernel on
(CUDA events, mean of 10 calls after warmup):
- `kernel`: the source as committed;
- `timed`: `%globaltimer` read at each phase boundary of the recurrence
  loop by one thread of every block (after a block barrier), summed per
  block over a call. Printed as the mean and the largest block's ms;
- ablations, which compute wrong outputs (only their times mean anything):
  unit_split: `no_dw` (the dW_hh update dropped), `no_p2_staging` (phase
  2's staging of dgates dropped); carry_only: `no_gates` (the gate product
  not launched), `no_dw` (the dW_hh product not launched), `no_staging`
  (the loop's cp.async staging of dgates dropped), `g1` (the plan forced to
  one video group: every block reads every video's dgates, the exchange of
  the old design); weight_stationary: `no_staging` (the cp.async staging of
  h dropped), `no_wait` (the wait at the group barrier dropped), `g1` (the
  plan forced to one video group: every block stages every video's h and
  waits for every block, as the first design's grid barrier did).
Prints the card's name and power limit first.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

SCRIPT_REPO = Path(__file__).resolve().parent.parent

TIMER = """
__device__ unsigned long long phase_ns[1024][16];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define TICK(i) do { __syncthreads(); if (threadIdx.x == 0) { \\
  const unsigned long long t1 = now_ns(); phase_ns[blockIdx.x][i] += t1 - t0; t0 = t1; } } while (0)
"""
READER = """extern "C" int phase_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_ns, sizeof(phase_ns));
}
extern "C" int phase_zero() {
  static unsigned long long zeros[1024][16];
  return (int)cudaMemcpyToSymbol(phase_ns, zeros, sizeof(zeros));
}
"""
TIMER_AT = ("namespace {\n\nconstexpr int kThreads", TIMER + "namespace {\n\nconstexpr int kThreads")
READER_AT = ('extern "C" int lstm_scan_plan(', READER + 'extern "C" int lstm_scan_plan(')

DESIGNS = {"backward": {
    "unit_split": {
        "phases": ["recompute", "cell", "dW_hh", "barrier", "p2_staging", "p2_loop"],
        "variants": {
            "kernel": [],
            "timed": [
                TIMER_AT, READER_AT,
                ("  for (int t = T - 1; t >= 0; --t) {\n    const bool last",
                 "  unsigned long long t0 = now_ns();\n"
                 "  for (int t = T - 1; t >= 0; --t) {\n    const bool last"),
                ("                                        : make_float4(0.f, 0.f, 0.f, 0.f);\n"
                 "      __syncthreads();\n      if (slice == 0) {",
                 "                                        : make_float4(0.f, 0.f, 0.f, 0.f);\n"
                 "      TICK(0);\n      if (slice == 0) {"),
                ("        dgs[bl * U + u] = dg4;  // zero for masked videos: they add nothing to "
                 "dW_hh\n      }\n      __syncthreads();",
                 "        dgs[bl * U + u] = dg4;  // zero for masked videos: they add nothing to "
                 "dW_hh\n      }\n      TICK(1);"),
                ("          dws[k * U + uu] = acc;\n        }\n      }\n    }\n"
                 "    if (t == 0) break;  // no earlier step to carry dh into\n    grid.sync();",
                 "          dws[k * U + uu] = acc;\n        }\n      }\n      TICK(2);\n    }\n"
                 "    if (t == 0) break;  // no earlier step to carry dh into\n    grid.sync();\n"
                 "    TICK(3);"),
                ("        __syncthreads();\n        stage_rows<true>(dxproj + ((size_t)t * B + b0) * G,"
                 " (int)G, c * H, nb, H, hsm);\n        __syncthreads();",
                 "        TICK(5);\n        stage_rows<true>(dxproj + ((size_t)t * B + b0) * G,"
                 " (int)G, c * H, nb, H, hsm);\n        TICK(4);"),
                ("        dh_carry[(size_t)(b0 + bl) * H + unit] = s;\n      }\n",
                 "        dh_carry[(size_t)(b0 + bl) * H + unit] = s;\n      }\n      TICK(5);\n"),
            ],
            "no_dw": [("      for (int k = tid; k < H; k += kThreads) {\n        for (int uu",
                       "      for (int k = H + tid; k < H; k += kThreads) {\n        for (int uu")],
            "no_p2_staging": [("stage_rows<true>(dxproj + ((size_t)t * B + b0) * G, (int)G, c * H, "
                               "nb, H, hsm);", "")],
        },
    },
    "carry_only": {
        "phases": ["cell", "barrier", "staging", "product"],
        "variants": {
            "kernel": [],
            "timed": [
                TIMER_AT, READER_AT,
                ("  for (int t = T - 1; t >= 0; --t) {  // the carry loop",
                 "  unsigned long long t0 = now_ns();\n"
                 "  for (int t = T - 1; t >= 0; --t) {  // the carry loop"),
                ("    if (t == 0) break;  // no earlier step to carry into\n",
                 "    TICK(0);\n    if (t == 0) break;  // no earlier step to carry into\n"),
                ("    group_wait(counters + g, (unsigned)S * (unsigned)(T - t));\n",
                 "    group_wait(counters + g, (unsigned)S * (unsigned)(T - t));\n    TICK(1);\n"),
                ("      cp_async_wait_all();  // the chunk of dgates\n      __syncthreads();\n",
                 "      cp_async_wait_all();  // the chunk of dgates\n      TICK(2);\n"),
                ("      __syncthreads();  // red is complete, dgs may be reused\n",
                 "      TICK(3);  // red is complete, dgs may be reused\n"),
            ],
            "no_gates": [("  err = launch_gates(", "  if (0) err = launch_gates(")],
            "no_dw": [("  if (err == cudaSuccess) err = launch_dw(",
                       "  if (0) err = launch_dw(")],
            "no_staging": [("        cp_async16(dgs + 4 * i, src + 4 * i);", "")],
            "g1": [("for (int G = 1; G <= B; ++G) {  // video groups",
                    "for (int G = 1; G <= 1; ++G) {  // video groups")],
        },
    },
}, "forward": {
    "weight_stationary": {
        "phases": ["barrier", "staging", "contraction", "cell", "slab"],
        "variants": {
            "kernel": [],
            "timed": [
                TIMER_AT, READER_AT,
                ("  prefetch_x(0);\n  __syncthreads();  // ws and csm are in place\n",
                 "  prefetch_x(0);\n  __syncthreads();  // ws and csm are in place\n"
                 "  unsigned long long t0 = now_ns();\n"),
                ("          __syncthreads();\n          if (active) {\n",
                 "          TICK(1);\n          if (active) {\n"),
                ("          __syncthreads();  // chunk c's buffer is free for chunk c + 2\n",
                 "          TICK(2);  // chunk c's buffer is free for chunk c + 2\n"),
                ("    if (t + 1 == T) break;\n    __syncthreads();  // hloc holds h(t) of the "
                 "block's pairs\n",
                 "    TICK(3);\n    if (t + 1 == T) break;\n"),
                ("    group_arrive(counter);\n    prefetch_x(t + 1);",
                 "    TICK(4);\n    group_arrive(counter);\n    prefetch_x(t + 1);"),
                ("    group_wait(counter, (unsigned)S * (unsigned)(t + 1));\n",
                 "    group_wait(counter, (unsigned)S * (unsigned)(t + 1));\n    TICK(0);\n"),
            ],
            "no_staging": [("  for (int i = threadIdx.x; i < n4; i += kThreads) "
                            "cp_async16(dst + 4 * i, src + 4 * i);\n", "")],
            "no_wait": [("    group_wait(counter, (unsigned)S * (unsigned)(t + 1));\n",
                         "    __syncthreads();\n")],
            "g1": [("for (int G = 1; G <= Bp && G * S <= sms; ++G) {  // video groups",
                    "for (int G = 1; G <= 1 && G * S <= sms; ++G) {  // video groups")],
        },
    },
}}


def pick_design(source, kernel):
    """The design of `kernel` whose every anchor the source holds."""
    for name, design in DESIGNS[kernel].items():
        anchors = [old for subs in design["variants"].values() for old, _ in subs]
        if all(old in source for old in anchors):
            return name, design
    raise RuntimeError(f"the source matches no known design of the {kernel}; update DESIGNS")


def build_variants(build, source, design, out):
    """Write and compile every variant at once; {name: loaded library}."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in design["variants"].items():
        text = source
        for old, new in subs:
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        registers = [line.strip() for line in log.splitlines() if "registers" in line]
        print(f"[build] variant={name} {registers}", flush=True)
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--kernel", choices=sorted(DESIGNS), default="backward")
    parser.add_argument("--root", type=Path, default=SCRIPT_REPO)
    parser.add_argument("batches", type=int, nargs="*", default=[16])
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("lstm_scan_phases: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import chip_smoke
    from objectpermanence_tpu_torch.ops import _build
    from objectpermanence_tpu_torch.ops import lstm_scan
    assert Path(lstm_scan.__file__).resolve().is_relative_to(root), lstm_scan.__file__

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    source = (root / "objectpermanence_tpu_torch" / "csrc" / "lstm_scan.cu").read_text()
    design_name, design = pick_design(source, args.kernel)
    libs = build_variants(_build, source, design,
                          SCRIPT_REPO / "build" / "lstm_scan_phases" / args.kernel)
    weights = chip_smoke.flagship_weights(device)
    for batch in args.batches:
        for layer in chip_smoke.LSTM_LAYERS:
            x, w_ih, w_hh, dout = chip_smoke.lstm_case(layer, batch, weights, device)
            xproj = torch.matmul(x.transpose(0, 1), w_ih).contiguous()
            hs, cs = lstm_scan.lstm_scan_forward_reference(xproj, w_hh)
            h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
            c_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
            dh_out = dout.transpose(0, 1).contiguous()
            fields = {}
            for name, lib in libs.items():
                _build._LIBS["lstm_scan"] = lib
                lstm_scan._FNS.clear()
                if hasattr(lstm_scan._scratch_bytes, "cache_clear"):
                    lstm_scan._scratch_bytes.cache_clear()  # a variant may plan another grid

                def run():
                    if args.kernel == "forward":
                        return lstm_scan.lstm_scan_forward(xproj, w_hh)
                    return lstm_scan.lstm_scan_backward(xproj, h_prev, c_prev, cs, dh_out, w_hh)

                fields[f"{name}_ms"] = chip_smoke.time_ms(run, iters=10)
                if name == "timed":
                    torch.cuda.synchronize()
                    assert lib.phase_zero() == 0
                    run()
                    torch.cuda.synchronize()
                    ns = np.zeros((1024, 16), dtype=np.uint64)
                    assert lib.phase_read(ns.ctypes.data) == 0
                    ran = ns.sum(axis=1) > 0
                    per_block = ns[ran].astype(np.float64) / 1e6
                    fields["blocks"] = int(ran.sum())
                    for i, phase in enumerate(design["phases"]):
                        fields[phase] = (f"{per_block[:, i].mean():.4f}/"
                                         f"{per_block[:, i].max():.4f}")
            chip_smoke.log("lstm_scan_phases", kernel=args.kernel, design=design_name,
                           layer=layer, batch=batch,
                           frames=chip_smoke.FRAMES, hidden=w_hh.shape[0], **fields)
    return 0


if __name__ == "__main__":
    sys.exit(main())

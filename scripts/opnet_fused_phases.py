"""Where the fused OPNet forward (K1, `csrc/opnet_fused.cu`) spends its time
on a CUDA card, phase by phase, with no profiler: variants of the source are
made by text substitution, built with the same nvcc flags as the port, and
loaded in place of the kernel library.

    python3 scripts/opnet_fused_phases.py [BATCH ...]     (default: 512 16)

Variants, each timed at every batch in float32 and bf16 operands (CUDA
events, mean of 10 calls after warmup), flagship weights and the served
boxes as `chip_smoke.py` tiles them:
- `kernel`: the source as committed;
- `timed`: the same with `%globaltimer` read at each phase boundary by one
  thread of every block (after a block barrier), summed per block over a
  call: C and A (the two LSTM phases of X_t, each split into its chunked
  contraction `*_loop`, its cell update `*_cell` and the rest, the slab
  store and the slice's shares), the barrier after X_t, Y_t (selection and
  box head) and the barrier after it. Printed as the mean and the largest
  block's milliseconds;
- `no_fma`: the contraction's 4V FMAs a row replaced by V + 4 adds, one
  for each loaded value, into separate sums (the loads stay): what the loop
  costs without its arithmetic;
- `no_staging`: the cp.async copies of h removed (the chunks' barriers
  stay): what staging h from L2 costs.
The ablations compute wrong outputs; only their times mean anything.
Prints the card's name and power limit first.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "objectpermanence_tpu_torch" / "csrc" / "opnet_fused.cu"
OUT = REPO / "build" / "opnet_fused_phases"
PHASES = ["C", "A", "sync_X", "Y", "sync_Y", "C_loop", "C_cell", "A_loop", "A_cell"]

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
VARIANTS = {
    "kernel": [],
    "timed": [
        ("namespace {\n\nconstexpr int kThreads", TIMER + "namespace {\n\nconstexpr int kThreads"),
        ("  for (int t = 0; t <= p.T; ++t) {",
         "  unsigned long long t0 = now_ns();\n  for (int t = 0; t <= p.T; ++t) {"),
        ("      lstm_dispatch<E, false>(p, L, step, sm);\n    }",
         "      lstm_dispatch<E, false>(p, L, step, sm);\n    }\n    TICK(0);"),
        ("      lstm_dispatch<E, true>(p, L, t, sm);\n    }\n    grid.sync();",
         "      lstm_dispatch<E, true>(p, L, t, sm);\n    }\n    TICK(1);\n    grid.sync();\n"
         "    TICK(2);"),
        ("    select_and_head<E>(p, t);\n    if (t < p.T) grid.sync();",
         "    select_and_head<E>(p, t);\n    TICK(3);\n    if (t < p.T) grid.sync();\n    TICK(4);"),
        ("  __syncthreads();  // the previous phase is done with the stage area and hloc",
         "  __syncthreads();  // the previous phase is done with the stage area and hloc\n"
         "  unsigned long long t0 = now_ns();"),
        ("    if constexpr (V == 1) {\n      if (KS > 1) {",
         "    TICK(kAtt ? 7 : 5);\n    if constexpr (V == 1) {\n      if (KS > 1) {"),
        ("  __syncthreads();\n  const int nu = max(0, min(L.U, L.H - L.u0));",
         "  TICK(kAtt ? 8 : 6);\n  const int nu = max(0, min(L.U, L.H - L.u0));"),
        ('extern "C" int opnet_fused_plan(', READER + 'extern "C" int opnet_fused_plan('),
    ],
    "no_fma": [("for (int v = 0; v < V; ++v) fma4(acc[v], h[v], w);",
                "for (int v = 0; v < V; ++v) acc[v].x += h[v];\n"
                "          acc[0].y += w.x; acc[0].z += w.y; acc[0].w += w.z; acc[V - 1].y += w.w;")],
    "no_staging": [("for (int i = threadIdx.x; i < n4; i += kThreads) cp_async16(dst + 4 * i, "
                    "src + 4 * i);", "")],
}


def build_variants(build):
    """Write and compile every variant at once; {name: loaded library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = SOURCE.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        registers = [line.strip() for line in log.splitlines() if "registers" in line]
        print(f"[build] variant={name} {registers}", flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("opnet_fused_phases: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from objectpermanence_tpu_torch.ops import _build
    from objectpermanence_tpu_torch.ops import opnet_fused as k1

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    libs = build_variants(_build)
    weights = chip_smoke.flagship_weights(device)
    for batch in [int(b) for b in sys.argv[1:]] or [512, 16]:
        boxes = chip_smoke.served_boxes(batch, device)
        for dtype in (torch.float32, torch.bfloat16):
            plan = k1.launch_plan(batch, weights[1].shape[0], weights[4].shape[0], dtype)
            fields = {}
            for name, lib in libs.items():
                _build._LIBS["opnet_fused"] = lib
                k1._FNS.clear()

                def run():
                    return k1.opnet_fused_forward(boxes, *weights, compute_dtype=dtype)

                with torch.inference_mode():
                    fields[f"{name}_ms"] = chip_smoke.time_ms(run, iters=10)
                    if name == "timed":
                        torch.cuda.synchronize()
                        assert lib.phase_zero() == 0
                        run()
                        torch.cuda.synchronize()
                        ns = np.zeros((1024, 16), dtype=np.uint64)
                        assert lib.phase_read(ns.ctypes.data) == 0
                        per_block = ns[:plan["blocks"]].astype(np.float64) / 1e6
                        for i, phase in enumerate(PHASES):
                            fields[phase] = (f"{per_block[:, i].mean():.3f}/"
                                             f"{per_block[:, i].max():.3f}")
            chip_smoke.log("opnet_fused_phases", batch=batch, dtype=str(dtype).split(".")[-1],
                           groups=plan["groups"], slices=plan["slices"], **fields)
    return 0


if __name__ == "__main__":
    sys.exit(main())

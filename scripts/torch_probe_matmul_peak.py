"""The card's measured matmul ceilings, the PyTorch twin of
`scripts/probe_matmul_peak.py`.

Each configuration times a dependent chain of ``tanh(W @ X)`` (tanh keeps
the chain from folding and models an MLP layer; its work is under 1% of
the matmul's at every shape here) with CUDA events after a warm-up chain:

  - square 4096^3 and 8192^3 float32 matmuls with TF32 off (the float32
    ceiling outside the tensor cores) and with TF32 on;
  - the same in bfloat16, for the record;
  - width-shaped chains, W x W @ W x 32768 for W in 64, 128, 256, 512 (the
    dense PINN's GEMM shapes at batch 32768), float32 with TF32 off and on,
    and W = 64, 128 at 524,288 columns.

One JSON line a configuration: the measured TFLOP/s, its share of the
published dense peak of one H100 SXM for its type (NVIDIA's data sheet,
700 W), and the card's name and power limit as nvidia-smi reads them.
Needs a CUDA card; without one it raises.

    python3 scripts/torch_probe_matmul_peak.py
"""

from __future__ import annotations

import json
import subprocess

import torch

# published dense peaks of one H100 SXM at 700 W, TFLOP/s
PEAK_TFLOPS = {"float32": 67.0, "tf32": 495.0, "bfloat16": 989.0}
SQUARE = {"f32_4096": ("float32", 4096, 50), "tf32_4096": ("tf32", 4096, 50),
          "bf16_4096": ("bfloat16", 4096, 50),
          "f32_8192": ("float32", 8192, 20), "tf32_8192": ("tf32", 8192, 20),
          "bf16_8192": ("bfloat16", 8192, 20)}
CHAIN_COLUMNS = 32_768


def configs() -> list[tuple]:
    """(name, type, (m, k, n), reps) of every configuration, in order."""
    out = [(name, kind, (s, s, s), reps)
           for name, (kind, s, reps) in SQUARE.items()]
    for w, reps in ((64, 400), (128, 400), (256, 200), (512, 200)):
        for kind in ("float32", "tf32"):
            tag = "f32" if kind == "float32" else kind
            out.append((f"w{w}_chain_{tag}", kind, (w, w, CHAIN_COLUMNS),
                        reps))
    out += [("w64_b524288_f32", "float32", (64, 64, 524_288), 50),
            ("w128_b524288_f32", "float32", (128, 128, 524_288), 50)]
    return out


def card() -> dict:
    """``{"device", "power_limit_w"}`` of card 0 as nvidia-smi reads them."""
    name, limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.splitlines()[0].split(", ")
    return {"device": name.strip(), "power_limit_w": float(limit)}


def chain_tflops(m: int, k: int, n: int, kind: str = "float32",
                 reps: int = 50, device="cuda") -> tuple[float, float]:
    """TFLOP/s of a ``reps``-long dependent chain of ``tanh((m, k) @ (k,
    n))`` (m = k) and its seconds, ``kind`` one of `PEAK_TFLOPS`: CUDA
    events around the chain after a warm-up chain on the card; the host
    clock on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_probe_matmul_peak: no CUDA card "
                           "(torch.cuda.is_available() is False)")
    if m != k:
        raise ValueError(f"a chain needs square weights, got m={m}, k={k}")
    dtype = torch.bfloat16 if kind == "bfloat16" else torch.float32
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((k, n), generator=g, device=device, dtype=dtype)
    w = torch.randn((m, k), generator=g, device=device,
                    dtype=dtype) / k ** 0.5

    def chain():
        y = x
        for _ in range(reps):
            y = torch.tanh(w @ y)
        return y

    flags = torch.backends.cuda.matmul
    previous = flags.allow_tf32
    flags.allow_tf32 = kind == "tf32"
    try:
        chain()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            torch.cuda.synchronize(device)
            seconds = start.elapsed_time(end) / 1e3
        else:
            import time

            t0 = time.perf_counter()
            chain()
            seconds = time.perf_counter() - t0
    finally:
        flags.allow_tf32 = previous
    return 2.0 * m * k * n * reps / seconds / 1e12, seconds


def measure(name: str, kind: str, shape, reps: int, device="cuda") -> dict:
    """One configuration's line, without the card's fields."""
    tflops, seconds = chain_tflops(*shape, kind, reps, device)
    return {"config": name, "type": kind, "shape": list(shape),
            "reps": reps, "tflops": tflops, "seconds": seconds,
            "peak_tflops": PEAK_TFLOPS[kind],
            "share_of_peak_pct": 100.0 * tflops / PEAK_TFLOPS[kind]}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_probe_matmul_peak: needs a CUDA card "
                         "(torch.cuda.is_available() is False)")
    info = card()
    for name, kind, shape, reps in configs():
        print(json.dumps({**measure(name, kind, shape, reps), **info}),
              flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the flash self-attention kernels (kernel rows 9 and 10) of one or
more checkouts of the PyTorch port on one NVIDIA GPU, in turns.

    python3 scripts/torch_attention_timing.py                # this checkout
    python3 scripts/torch_attention_timing.py --roots OLD . . OLD

Each root is a directory that holds ``adaptpoint_tpu_torch``; each runs in a
child process of its own, which builds that checkout's kernels and prints
one JSON line. At the mask head's shape (128, 2048, 16), scale 4, seeded
inputs: CUDA-event ms of the forward with the backward's extras and without,
and of the backward, for bf16 inputs (what the bf16 policy's
``AnchorSelfAttention`` passes) and for f32 inputs;
``scaled_dot_product_attention`` and its autograd backward on the same bf16
inputs; the device time of each kernel of one bf16 forward and backward from
``torch.profiler``; the backward's peak scratch memory; whether two
backward runs agree bit for bit; each kernel's registers and spill bytes;
and the largest |kernel - plain| / (1 + |plain|) at (8, 2048, 16) and
(2, 129, 16) for bf16 inputs. The card's name and power limit
(``nvidia-smi``) lead the output. ``--out`` gets the same lines.

Compare two checkouts only inside one run: hosts and clocks differ between
machines. Needs a GPU; exits with 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

SHAPE, SCALE = (128, 2048, 16), 4.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cuda_ms(fn, min_total_ms: float = 300.0) -> float:
    """Mean ms of ``fn()`` by CUDA events after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    reps = int(min(100, max(5, min_total_ms / one)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def child(root: str) -> dict:
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, os.path.abspath(root))
    from adaptpoint_tpu_torch.ops import _build, attention

    _build.build_all(["attention"])
    log = _build.build_logs.get("attention", "")
    names = re.findall(r"entry function '(\w+)'", log)
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"root": os.path.abspath(root), "shape": list(SHAPE),
           "scale": SCALE, "registers": {
               n: [int(r), int(sp)]
               for n, r, sp in zip(names, regs, spills)}}
    # agreement with the plain versions, bf16 inputs (the tests and
    # chip_smoke.py hold every shape; this guards the timed build)
    for shape in ((8, 2048, 16), (2, 129, 16)):
        q, k, v, do = [torch.randn(shape, generator=gen, device="cuda")
                       for _ in range(4)]
        q, k, v = [t.to(torch.bfloat16) for t in (q, k, v)]
        out, saved = attention.mha_cuda(q, k, v, SCALE, for_backward=True)
        got = (out, *attention.mha_bwd_cuda(q, k, v, SCALE, do, saved))
        ref = (attention.mha_plain(q, k, v, SCALE),
               *attention.mha_bwd_plain(q, k, v, SCALE, do))
        res[f"max_scaled_err_{shape[1]}"] = max(
            float(((a.float() - b.float()).abs() / (1 + b.float().abs()))
                  .max()) for a, b in zip(got, ref))
    q, k, v, do = [torch.randn(SHAPE, generator=gen, device="cuda")
                   for _ in range(4)]
    qb, kb, vb = [t.to(torch.bfloat16) for t in (q, k, v)]
    for tag, (a, b, c) in (("bf16", (qb, kb, vb)), ("f32", (q, k, v))):
        _, saved = attention.mha_cuda(a, b, c, SCALE, for_backward=True)
        res[f"fwd_ms_{tag}"] = cuda_ms(
            lambda: attention.mha_cuda(a, b, c, SCALE, for_backward=True))
        res[f"fwd_only_ms_{tag}"] = cuda_ms(
            lambda: attention.mha_cuda(a, b, c, SCALE))
        res[f"bwd_ms_{tag}"] = cuda_ms(
            lambda: attention.mha_bwd_cuda(a, b, c, SCALE, do, saved))
    bh, n, d = SHAPE
    ql, kl, vl = [t.reshape(1, bh, n, d).requires_grad_()
                  for t in (qb, kb, vb)]
    dob = do.to(torch.bfloat16).reshape(1, bh, n, d)
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=1.0 / SCALE)
    res["sdpa_fwd_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, scale=1.0 / SCALE))
    res["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dob, retain_graph=True))

    _, saved = attention.mha_cuda(qb, kb, vb, SCALE, for_backward=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    first = attention.mha_bwd_cuda(qb, kb, vb, SCALE, do, saved)
    res["bwd_peak_scratch_gb"] = (torch.cuda.max_memory_allocated()
                                  - base) / 2 ** 30
    second = attention.mha_bwd_cuda(qb, kb, vb, SCALE, do, saved)
    res["bwd_repeats_bit_for_bit"] = all(
        torch.equal(x, y) for x, y in zip(first, second))

    reps = 20
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            _, saved = attention.mha_cuda(qb, kb, vb, SCALE,
                                          for_backward=True)
            attention.mha_bwd_cuda(qb, kb, vb, SCALE, do, saved)
        torch.cuda.synchronize()
    res["kernel_ms_bf16"] = {
        e.key.replace("(anonymous namespace)::", "").split("(")[0][-48:]:
        e.self_device_time_total / 1e3 / reps
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    res["device"] = torch.cuda.get_device_name(0)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+", default=[REPO],
                    help="checkouts to time, in this order (default: this "
                         "one)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "attention_timing.jsonl"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines = [json.dumps({"nvidia_smi": smi})]
    print(lines[0], flush=True)
    for root in args.roots:
        got = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root], capture_output=True,
                             text=True)
        if got.returncode != 0:
            sys.stderr.write(got.stdout + got.stderr)
            return got.returncode
        lines.append(got.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

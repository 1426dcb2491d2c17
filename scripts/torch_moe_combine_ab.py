"""The port's MoE combine, top-k grid against the (T * E) grid, on one card.

``permutation.token_combine`` sums each token's expert outputs in a fixed
order. Given ``topk`` (as ``moe`` passes it) it sorts the T * topk slots by
(token, expert) and sums a (T, topk, H) view; without it each slot goes to
its own row of a zero-filled (T * E, H) grid, E / topk times the terms.
This script times both forms at the serving prefill's size (B 8 x 512
tokens) of MIXTRAL_8X7B and GPTOSS_20B: the combine alone, the ``moe``
forward without a gradient, and its forward and backward, interleaved
(grid, top-k, top-k, grid) with CUDA events, and the combine's transient
memory. Weights are random bf16 from a seed.

    python3 scripts/torch_moe_combine_ab.py            # on the card
    python3 scripts/torch_moe_combine_ab.py --small --device cpu

Prints the card's name and power limit, one line per reading, and a JSON
object last."""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from transformerengine_tpu_torch import moe as moe_mod  # noqa: E402
from transformerengine_tpu_torch import permutation  # noqa: E402

CONFIGS = {
    "mixtral_8x7b": dict(h=4096, e=8, f=14336, topk=2, act="swiglu"),
    "gptoss_20b": dict(h=2880, e=32, f=2880, topk=4, act="clamped_swiglu"),
}
SMALL = dict(h=64, e=8, f=96)


def _timer(dev):
    if dev.type == "cuda":
        def run(fn):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b)
    else:
        def run(fn):
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
    return run


def _grid_combine(expert_out, probs, aux, topk=None):
    return permutation.token_combine(expert_out, probs, aux)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--tokens", type=int, default=8 * 512)
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    t = 64 if args.small else args.tokens
    timed = _timer(dev)
    real = moe_mod.token_combine
    forms = {"grid": _grid_combine, "topk": real}
    out = {}
    for name, cfg in CONFIGS.items():
        cfg = dict(cfg, **(SMALL if args.small else {}))
        h, e, f, k = cfg["h"], cfg["e"], cfg["f"], cfg["topk"]
        gen = torch.Generator(device=dev).manual_seed(0)

        def rand(*shape, scale=1.0):
            return (torch.randn(shape, device=dev, generator=gen) * scale
                    ).bfloat16()
        x = rand(t, h)
        router = torch.randn((h, e), device=dev, generator=gen) / h ** 0.5
        w_up = rand(e, h, 2 * f, scale=h ** -0.5)
        w_down = rand(e, f, h, scale=f ** -0.5)
        logits = x.float() @ router
        routing = torch.zeros((t, e), dtype=torch.bool, device=dev)
        routing.scatter_(1, logits.topk(k, dim=-1).indices, True)
        probs = torch.where(routing, logits.softmax(-1), 0.0)
        _, aux = permutation.token_dispatch(x, routing, t * k)
        expert_out = rand(t * k, h)

        def combine(form):
            return lambda: forms[form](expert_out, probs, aux, topk=k)

        def forward(form):
            def run():
                moe_mod.token_combine = forms[form]
                try:
                    with torch.no_grad():
                        moe_mod.moe(x, router, w_up, w_down, topk=k,
                                    activation_type=cfg["act"])
                finally:
                    moe_mod.token_combine = real
            return run

        def train(form):
            xg = x.clone().requires_grad_()

            def run():
                moe_mod.token_combine = forms[form]
                try:
                    y, aux_loss = moe_mod.moe(xg, router, w_up, w_down,
                                              topk=k,
                                              activation_type=cfg["act"])
                    (y.float().sum() + aux_loss).backward()
                finally:
                    moe_mod.token_combine = real
            return run

        same = torch.equal(combine("grid")(), combine("topk")())
        rows = {"combine_bitwise_equal": same}
        for what, make in (("combine", combine), ("moe_forward", forward),
                           ("moe_train_step", train)):
            times = {"grid": [], "topk": []}
            for form in ("grid", "topk"):
                make(form)()                      # warm-up
            for _ in range(args.reps):
                for form in ("grid", "topk", "topk", "grid"):
                    times[form].append(timed(make(form)))
            for form, ts in times.items():
                rows[f"{what}_{form}_median_ms"] = statistics.median(ts)
                rows[f"{what}_{form}_least_ms"] = min(ts)
        if dev.type == "cuda":
            for form in ("grid", "topk"):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                combine(form)()
                torch.cuda.synchronize()
                rows[f"combine_{form}_transient_mib"] = (
                    torch.cuda.max_memory_allocated() - base) / 2 ** 20
        for key, v in rows.items():
            print(f"{name} T={t} H={h} E={e} top-{k}: {key} {v}")
        out[name] = dict(tokens=t, hidden=h, experts=e, topk=k, **rows)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

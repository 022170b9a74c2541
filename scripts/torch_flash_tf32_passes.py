"""How much accuracy the flash backward's three TF32 passes buy, on the card.

Builds the port's kernels twice, as shipped (three TF32 passes a product in
the flash backward, x = hi + lo, a b = lo hi + hi lo + hi hi) and with
``-DFLASH_BWD_TF32_PASSES=1`` (the hi hi pass alone), and holds each build's
backward against the plain version on ``chip_smoke.py``'s flash cases, with
its limits: ``FLASH_GRAD_RTOL`` of the largest |value| plus ``YARDSTICK``
times the plain version's distance from float64 dense attention. Prints,
for each build and case, max |kernel - plain| of dq, dk and dv with their
limits, then one JSON line. Exits 1 if the shipped build misses a limit.

    python3 scripts/torch_flash_tf32_passes.py    # from the repo root, on a card
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from pointasnl_tpu_torch.ops import flash_attention as fa  # noqa: E402
from pointasnl_tpu_torch.ops.cuda import _build  # noqa: E402
from pointasnl_tpu_torch.ops.cuda import flash_attention as cuda_flash  # noqa: E402


def errors(dev) -> dict:
    """{case: {grad: (max |kernel - plain|, limit)}} of the loaded build."""
    out = {}
    for name, (B, M, N, C, D, scaled, qmul) in smoke.FLASH_CASES.items():
        scale = fa.flash_scale(C, scaled)
        q, k, v, do = smoke.flash_inputs(name, B, M, N, C, D, qmul, dev)
        po, plse = fa.flash_forward_reference(q, k, v, scale)
        grads = cuda_flash.flash_backward(q, k, v, po, plse, do, scale)
        plain = fa.flash_backward_reference(q, k, v, po, plse, do, scale)
        _, _, ref64 = smoke.dense64(q, k, v, do, scale)
        out[name] = {}
        for what, got, p, ref in zip(("dq", "dk", "dv"), grads, plain, ref64):
            f32 = float((p.double() - ref).abs().max())
            limit = smoke.FLASH_GRAD_RTOL * float(ref.abs().max()) + smoke.YARDSTICK * f32
            out[name][what] = (float((got.double() - p.double()).abs().max()), limit)
    return out


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    shipped = list(_build.NVCC_FLAGS)
    summary = {}
    for passes in (3, 1):
        _build._lib = None  # the flags key the build: each loads its own library
        _build.NVCC_FLAGS = shipped + ([] if passes == 3 else [f"-DFLASH_BWD_TF32_PASSES={passes}"])
        errs = errors(dev)
        missed = []
        for name, by_grad in errs.items():
            print(f"{passes} pass(es), flash {name}: " + ", ".join(
                f"{w} {e:.3e} (limit {lim:.3e}, {e / lim:.3f} of it)"
                for w, (e, lim) in by_grad.items()))
            missed += [f"{name} {w}" for w, (e, lim) in by_grad.items() if not e <= lim]
        worst = max(e / lim for by_grad in errs.values() for e, lim in by_grad.values())
        print(f"{passes} pass(es): {len(missed)} of {3 * len(errs)} gradients over their limit; "
              f"worst error / limit {worst:.3f}  [{card}]")
        summary[passes] = {"missed": missed, "worst_ratio": worst,
                           "worst_abs": max(e for g in errs.values() for e, _ in g.values())}
    _build.NVCC_FLAGS = shipped
    print(json.dumps({"card": card, "passes": summary}))
    return 1 if summary[3]["missed"] else 0


if __name__ == "__main__":
    sys.exit(main())

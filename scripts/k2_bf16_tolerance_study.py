"""How the bf16 tolerance of K2 (flash attention's tensor-core route)
separates sound arithmetic from faulty kernels, on the CPU.

    PYTHONPATH=src:tests python scripts/k2_bf16_tolerance_study.py

Prints one JSON line per measurement:

* ``sound``: the kernel's arithmetic (128 x 128 tiles, P rounded to bf16
  before P V; the P-rounding loop of tests/test_torch_flash_attention.py)
  against the plain version, as the largest ``|got - want| / (atol +
  rtol |want|)`` for candidate (atol, rtol) pairs, and as the largest
  relative error of a row of a head (``chip_smoke.row_rel_ratio``, as a
  share of ``chip_smoke.FLASH_ROW_REL``'s bf16 bound, with the raw
  value), on the first 512 rows of olmo-1b's (4, 16, ., 128),
  zamba2-2.7b's (4, 32, ., 80) and two rows of granite-moe-3b's (2, 24,
  ., 64) causal calls (causal attention computes those rows as it does
  at s = 4096), three seeds;
* ``fault``: the same ratios for the faulty outputs of ``chip_smoke.py``'s
  ``WRONG_KERNELS`` against the plain version, at (1, 4, 2048, 128),
  (1, 6 -> 2, 2048, 80) and (1, 6 -> 2, 2048, 64), under
  ``chip_smoke.FLASH_TOL``'s bf16 pairs and ``FLASH_ROW_REL``'s bound.

Needs the reference package only through the test module it borrows
the P-rounding loop from.  About 10 s on 8 CPU threads.
"""

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from test_torch_flash_attention import _plain_bf16_p  # noqa: E402

CANDIDATES = ((2e-3, 1.6e-2), (3e-3, 1.6e-2), (4e-3, 1.6e-2))


def main() -> None:
    torch.set_num_threads(8)
    rel = chip_smoke.FLASH_ROW_REL[torch.bfloat16]
    for b, h, s, hd in ((4, 16, 512, 128), (4, 32, 512, 80),
                        (2, 24, 512, 64)):
        for seed in range(3):
            gen = torch.Generator().manual_seed(seed)
            q, k, v = (torch.randn((b, h, s, hd), generator=gen)
                       .to(torch.bfloat16) for _ in range(3))
            want = K.flash_attention_plain(q, k, v, scale=hd**-0.5)
            got = _plain_bf16_p(q, k, v, scale=hd**-0.5)
            row = chip_smoke.row_rel_ratio(got, want, rel)[0]
            print(json.dumps({
                "sound": [b, h, s, hd], "seed": seed,
                "max_abs_err": (got.float() - want.float()).abs().max().item(),
                "tol_ratio": {f"{a:g},{r:g}": chip_smoke.tol_ratio(
                    got, want, ((a, r),)) for a, r in CANDIDATES},
                "row_rel_ratio": row, "row_rel": row * rel}))
    tols = chip_smoke.FLASH_TOL[torch.bfloat16]
    gen = torch.Generator().manual_seed(0)
    for h, kvh, hd in ((4, 4, 128), (6, 2, 80), (6, 2, 64)):
        q, k, v = (torch.randn((1, n, 2048, hd), generator=gen)
                   .to(torch.bfloat16) for n in (h, kvh, kvh))
        want = K.flash_attention_plain(q, k, v, scale=hd**-0.5)
        for fault, drop in chip_smoke.WRONG_KERNELS.items():
            bad = chip_smoke.wrong_attention(q, k, v, hd**-0.5, drop)
            print(json.dumps({
                "fault": fault, "shape": [1, h, kvh, 2048, hd],
                "tol_ratio": chip_smoke.tol_ratio(bad, want, tols),
                "tol_ratio_atol_2e-2_only": chip_smoke.tol_ratio(
                    bad, want, tols[:1]),
                "row_rel_ratio": chip_smoke.row_rel_ratio(bad, want,
                                                          rel)[0]}))


if __name__ == "__main__":
    main()

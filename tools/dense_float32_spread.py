#!/usr/bin/env python3
"""The one-ulp spread of the dense nb=600 float32 solve's counters on the
card, where its LDLᵀ is the kernel K7.

``madnlp(opf.build(nb=600, seed=0))`` with default options (condensed
dense KKT, blocked LDLᵀ at block 128) in float32 on the GPU, once as it is
and once per seed with every factorized matrix perturbed by one float32
ulp of seeded symmetric noise (relative 1.2e-7), as
``tests/test_torch_refine_stall.py:dense_float32_spread`` does on the CPU:
the spread of (iterations, factorization_cnt, backsolve_cnt) that rounding
alone produces.  One line per solve, then the spread.

    python3 tools/dense_float32_spread.py [seeds]
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import madnlp_tpu_torch as T  # noqa: E402
from madnlp_tpu_torch.models.instances import opf  # noqa: E402
from madnlp_tpu_torch.ops import dense_solvers as ds  # noqa: E402


def spread(seeds):
    factorize = ds.factorize
    model = opf.build(nb=600, seed=0)
    rows = []
    for seed in [None] + list(range(seeds)):
        gen = (None if seed is None
               else torch.Generator(device="cuda").manual_seed(seed))

        def perturbed(K, *args, **kwargs):
            if gen is not None:
                E = torch.randn(K.shape, generator=gen, dtype=torch.float64,
                                device=K.device)
                K = (K * (1.0 + 1.2e-7 * (E + E.T) / 2.0)).to(K.dtype)
            return factorize(K, *args, **kwargs)

        ds.factorize = perturbed
        try:
            s = T.madnlp(model, dtype="float32",
                         print_level=T.PrintLevel.ERROR)
        finally:
            ds.factorize = factorize
        c = s.counters
        row = {"seed": seed, "status": s.status.name, "iter": s.iter,
               "factorization_cnt": c["factorization_cnt"],
               "backsolve_cnt": c["backsolve_cnt"], "objective": s.objective}
        print(json.dumps(row), flush=True)
        rows.append(row)
    keys = ("iter", "factorization_cnt", "backsolve_cnt")
    print(json.dumps({"spread": {k: (min(r[k] for r in rows),
                                     max(r[k] for r in rows)) for k in keys},
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return rows


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    spread(int(sys.argv[1]) if len(sys.argv) > 1 else 11)

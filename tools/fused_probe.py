#!/usr/bin/env python3
"""Where the whole-band kernels K5 and K6 spend their time, on one NVIDIA
GPU, at case118's KKT geometry (b = 64, bw = 5, nb = 10) on a seeded
diagonally dominant band, float32 and float64:

* the diagonal step alone at b = 64 (one CTA, the tiled routine K5 runs
  once per block column), by CUDA events;
* K5, its witness and K1 in turns (``chip_smoke.py:_time_turns``);
* K6 on one right-hand side (its column of the 8 padded ones, with the
  plan of ``fused_solve_plan`` and on clusters of 8, 4, 2 and 1 CTAs) and
  on all 8 columns with every tile width
  (``solve_plan_with``: 8, 4, 2 and 1 columns per cluster, the largest
  cluster that keeps the tiles in one wave), each held bit for bit
  against the witness, beside the witness, K2 (one column) and K2's
  witness, in turns.

Run from the repository root:  python3 tools/fused_probe.py
Prints one JSON line per dtype, and the card's name and power limit.
"""

import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("fused_probe: needs a CUDA device")
    import chip_smoke as cs
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.ops import banded_fused_kernels as bf
    from madnlp_tpu_torch.ops import banded_kernels as bk
    from madnlp_tpu_torch.testing import band_system

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    b, bw, nb = 64, 5, 10
    N = nb * b - b // 2
    rows, cols, vals = band_system(11, N, b, bw)
    st = plain.BandStructure(rows, cols, N, block=b, perm=np.arange(N))
    for dtype in (torch.float32, torch.float64):
        band0 = st.assembly(st.map(rows, cols), "cpu")(
            torch.as_tensor(vals)).to(dtype).cuda()
        f = bf.banded_fused_factorize(st, band0.clone())
        work = torch.empty_like(band0)
        invL = torch.zeros_like(f.invL)
        d = torch.ones((st.nbp * b,), dtype=dtype, device="cuda")
        A0 = band0[nb // 2, 0].contiguous()[None]
        A, R, dd = A0.clone(), torch.empty_like(A0), A0.new_empty((1, b))
        out = {"dtype": str(dtype), "b": b, "bw": bw, "nb": nb,
               "K5_plan": bf.factorize_plan_for(band0, nb, b, bw)._asdict()}
        out["diag_step_ms"] = cs._time_events(
            torch, lambda: bk.banded_diag_step_cuda(A, R, dd, tiled=True),
            lambda: A.copy_(A0), 50)
        out["factorize_ms"] = cs._time_turns(torch, {
            "K5": lambda: bf.banded_fused_factorize_cuda(work, invL, d, nb,
                                                         b, bw),
            "K5_witness": lambda: bf.banded_fused_factorize_reference_cuda(
                work, invL, d, nb, b, bw),
            "K1": lambda: bk.banded_factorize_cuda(work, invL, d, nb, b, bw)},
            lambda: work.copy_(band0), 6)
        rhs = torch.as_tensor(np.random.default_rng(3).standard_normal(st.N),
                              dtype=dtype, device="cuda")
        x0, dpad = bf._padded(st, f, rhs)
        ref = x0.clone()
        bf.banded_fused_solve_reference_cuda(f.band, f.invL, dpad, ref)
        x = x0.clone()
        r1 = x0[:, :1].contiguous()
        rw = torch.empty_like(r1)
        caps = bk.max_clusters(dtype)
        lib = bf.load()
        fn = getattr(lib, "banded_fused_solve_" + bf._SUFFIX[dtype])
        stream = torch.cuda.current_stream().cuda_stream
        fns, plans, equal = {}, {}, {}
        kp = x.shape[1]
        variants = [("k1", 1, bf.fused_solve_plan(b, bw, nb, 1, dtype, caps))]
        # one right-hand side on a cluster of each size the card keeps
        variants += [(f"k1_C{c}", 1, bf.solve_plan_with(
            b, bw, nb, 1, 1, dtype, {c: caps.get(c, 0)} if c > 1 else {}))
            for c in (8, 4, 2, 1)]
        variants += [(f"k8_cols{w}", kp,
                      bf.solve_plan_with(b, bw, nb, kp, w, dtype, caps))
                     for w in (8, 4, 2, 1)]
        for name, n, plan in variants:
            if plan is None:
                continue

            def launch(plan=plan, n=n):
                err = fn(f.band.data_ptr(), f.invL.data_ptr(),
                         dpad.data_ptr(), x.data_ptr(), nb, b, bw, kp, n,
                         plan.cols, plan.clusters, plan.rows, plan.stages,
                         stream)
                if err:
                    raise RuntimeError(f"K6 {plan}: CUDA error {err}")
            x.copy_(x0)
            launch()
            torch.cuda.synchronize()
            equal[name] = cs._same_bits(torch, x, ref)
            fns[f"K6_{name}"] = launch
            plans[name] = plan._asdict()
        fns["K6_witness"] = lambda: bf.banded_fused_solve_reference_cuda(
            f.band, f.invL, dpad, x)
        fns["K2"] = lambda: bk.banded_solve_cuda(f.band, f.invL, f.d, rw)
        fns["K2_witness"] = lambda: bk.banded_solve_reference_cuda(
            f.band, f.invL, f.d, rw)

        def setup():
            x.copy_(x0)
            rw.copy_(r1)
        out["solve_ms"] = cs._time_turns(torch, fns, setup, 10)
        out["K6_plans"] = plans
        out["K6_equal_to_witness"] = equal
        print(json.dumps(out), flush=True)
        if not all(equal.values()):
            sys.exit(f"a K6 tile width differs from the witness: {equal}")


if __name__ == "__main__":
    main()

"""One rank of the 2-process gloo runs of ``tests/test_torch_parallel.py``
and ``tests/test_torch_raster.py``.

Joins the group through the port's ``init_multihost``, runs every case of
``tests/torch_parallel_cases.py`` on its rows of the global batch, saves
each case's result to ``<out_dir>/<case>_r<rank>.pt`` and prints one
``RESULT rank=<r> cases=<n>`` line.

With a fifth argument ``serving`` it runs the serving cases of
``tests/test_torch_raster.py`` instead (the raster predictor, the
evaluation, the sweep) and saves ``<out_dir>/serving_r<rank>.pt``.

Run: python tests/torch_parallel_worker.py <port> <world> <rank> <out_dir>
     [serving]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    port, world, rank, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    import torch

    torch.set_num_threads(1)
    from tests import torch_parallel_cases as cases
    from uemda_tpu_torch.parallel.multihost import init_multihost

    init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    if len(sys.argv) > 5 and sys.argv[5] == "serving":
        torch.save(cases.run_serving_cases(
            os.path.join(out, "serving_bundle.pt"), out),
            f"{out}/serving_r{rank}.pt")
        print(f"RESULT rank={rank} cases=1", flush=True)
        return
    done = 0
    for name in cases.STEP_CASES:
        t = time.time()
        torch.save(cases.run_step_case(name), f"{out}/{name}_r{rank}.pt")
        print(f"{name}: {time.time() - t:.1f} s", flush=True)
        done += 1
    torch.save(cases.run_audit(), f"{out}/audit_r{rank}.pt")
    torch.save(cases.run_rundir_case(out), f"{out}/rundir_r{rank}.pt")
    if os.path.exists(os.path.join(out, "jax_bundle.pt")):
        torch.save(cases.run_jax_bundle(os.path.join(out, "jax_bundle.pt")),
                   f"{out}/jax_r{rank}.pt")
    print(f"RESULT rank={rank} cases={done + 2}", flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The controls of a cell's correctness check, on the cell's own sizes:

    python3 port_bench/control.py --workload <cell> --seeds 11 12 13 [--fault half_batch]

For each seed: the reference computed in the nearest precision below the
configuration's (TF32 for float32 with TF32 off) or, with ``--fault``, the
reference with a planted fault, put in the program's place and held against
the reference by the cell's own comparison. One JSON line per seed: the
numbers, the limits and whether the run would have been correct. Every
line must read ``"correct": false``. It needs the cell's CUDA devices.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import run  # noqa: E402
from port_bench.lib import faults, spec  # noqa: E402


def control(workload: str, seed: int, fault=None, device=None, traffic_overrides=None,
            config_overrides=None) -> dict:
    cell = spec.Cell(workload)
    import torch  # noqa: PLC0415
    dev = run.device_or_exit(cell.chips) if device is None else torch.device(device)
    env = run.Env(cell, seed, dev, False)
    env.traffic.update(traffic_overrides or {})
    if config_overrides:
        env.config = {k: (dict(v, **config_overrides[k]) if k in config_overrides else v)
                      for k, v in env.config.items()}
    driver = cell.driver()
    if env.traffic["driver"] == "edit":
        values = driver.control(env, list(range(env.traffic["check_batches"])))
    else:
        trainers = faults.TRAINERS[env.traffic["driver"]]
        values = driver.control(env, trainers[fault] if fault else None)
    limits = env.traffic["limits"]
    return {"workload": workload, "seed": seed, "fault": fault or "tf32",
            "correct": all(values[k] <= limits[k] for k in limits),
            "values": values, "limits": limits}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=sorted({f for t in faults.TRAINERS.values() for f in t}))
    args = p.parse_args(argv)
    for seed in args.seeds:
        t = time.perf_counter()
        out = control(args.workload, seed, args.fault)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

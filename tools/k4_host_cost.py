"""Host microseconds per call of the K4 wrappers (``prox_*_pallas``) of one
checkout of the port, on a CUDA card.

    python3 tools/k4_host_cost.py [--repo DIR] [--label NAME]

imports ``proxmin_tpu_torch`` from ``DIR`` (default: this checkout), so that
two checkouts, e.g. a parent commit unpacked with ``git archive``, are
compared by running this script on each, in turns, on one card. The cases
are ``chip_smoke.PROX_CASES`` (of this checkout) on a float32 (7, 1e6)
tensor with the step a 0-d tensor on the card, as the solvers call the
wrappers, each timed by ``chip_smoke.host_us``: 1000 calls in batches, each
batch enqueued behind a sleep kernel that holds the stream, so the host
never waits on the card. Prints one JSON object
``{"label": ..., "host_us": {case: us}}``.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch
    from proxmin_tpu_torch.ops import prox_kernels as pk

    # this checkout's chip_smoke, whichever checkout the wrappers come from
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    X = torch.randn((7, 1_000_000), generator=gen, device=dev)
    P = X.abs() + 0.1
    step = torch.tensor(0.37, device=dev)
    out = {}
    for case, op, kw in cs.PROX_CASES:
        fn = cs.prox_pair(pk, op)[0]
        Z = P if op == "unity" else X
        out[case] = cs.host_us(lambda: fn(Z, step, **kw))
    print(json.dumps({"label": args.label or args.repo, "host_us": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

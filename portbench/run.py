"""Run one cell of the port's benchmark once on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints progress on standard error, then each
number that decided ``correct`` beside its limit as the last lines there,
and one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last. Exits 2 without a result where there is
no CUDA card or fewer than the cell asks for, 3 where JAX or the JAX
package was loaded, 1 on any other failure.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mazu_tpu")


def process_age() -> float:
    """Seconds since this process started, from /proc (0 where that is not
    readable)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - start / os.sysconf("SC_CLK_TCK")
        return age if 0.0 <= age < 600.0 else 0.0
    except (OSError, ValueError, IndexError):
        return 0.0


def loaded_forbidden() -> list:
    """Top-level module names of JAX, its libraries or the JAX package that
    this process has loaded (whole names: ``mazu_tpu_torch`` is not
    ``mazu_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    t_start = T0 - process_age()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path[0] = str(ROOT)

    import torch

    from portbench.harness import cell_spec, log, run_cell

    spec = cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {spec['chips']} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                       t_start=t_start)
    except Exception:
        traceback.print_exc()
        return 1
    found = loaded_forbidden()
    if found:
        print(f"portbench: this process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    log(f"the run took {time.perf_counter() - T0:.1f} s")
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Does a process's first multithreaded ``torch.sin`` on the CPU give the
same values as its later ones?

    python -m mosaic_tpu_torch.bench.cpu_first_call [--procs 16]
        [--n 800000]

Each of ``--procs`` fresh Python processes takes the f32 latitude column
of an [n, 2] point array (a strided view, as the cell kernel's plain
version takes it), converts it to radians and takes its sine, twice, and
then the sine of the first call's radians once more.  It prints how many
of the n radians differ between the two calls, how many sines of the
first and of the second call differ from the third, and the first and
last index where the first call's sine does.  The calls are the first
steps of ``ops.cell.latlng_to_cell_margin_ref`` on absolute points; with
n above torch's intra-op grain (32,768) they run on several threads.
The script prints one JSON line: torch's version and thread count, the
processes whose first sine differed, and each process's counts and span.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

PROBE = r"""
import sys
import numpy as np
import torch
n = int(sys.argv[1])
rng = np.random.default_rng(0)
xy = torch.from_numpy(np.stack([rng.uniform(-74.25, -73.75, n),
                                rng.uniform(40.5, 40.9, n)], -1
                               ).astype(np.float32))


def f():
    rad = xy[:, 1].to(torch.float32) * 0.017453292519943295
    return rad, torch.sin(rad)


(r1, s1), (r2, s2) = f(), f()
s3 = torch.sin(r1)
bad = (s1 != s3).nonzero().flatten()
print(int((r1 != r2).sum()), len(bad), int((s2 != s3).sum()),
      int(bad[0]) if len(bad) else -1, int(bad[-1]) if len(bad) else -1)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=16)
    ap.add_argument("--n", type=int, default=800_000)
    args = ap.parse_args(argv)
    import torch
    runs = []
    for _ in range(args.procs):
        out = subprocess.run([sys.executable, "-c", PROBE, str(args.n)],
                             capture_output=True, text=True, check=True)
        runs.append([int(v) for v in out.stdout.split()])
    print(json.dumps({"torch": torch.__version__,
                      "threads": torch.get_num_threads(), "n": args.n,
                      "procs": args.procs,
                      "first_sine_differed": sum(1 for r in runs if r[1]),
                      "runs [radians differ, first sine differs, second "
                      "sine differs, first index, last index]": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

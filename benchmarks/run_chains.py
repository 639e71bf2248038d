"""Run every chain benchmark and record the results machine-readably.

Runs each benchmarks/*_bench.py in turn, one process at a time (one JAX
process per card), collects every JSON line each prints, and writes

    {"host_card": "<nvidia-smi name, power limit>",
     "chains": [ {...one record per printed line, each with the
                  "device" its bench ran on...} ],
     "failed": [ {"name": ..., "rc": ..., "stderr_tail": ..., ...} ]}

to ``-o`` (default ``out/bench_chains.json``).  A failed bench is
recorded with its exit code, elapsed time and stderr tail, and makes the
runner exit nonzero.  This parent process never touches the card.

Run from the repo root on the GPU:  python benchmarks/run_chains.py [names]
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import bench  # noqa: E402

# (name, timeout_s)
BENCHES = [
    ("executor_overhead_bench.py", 900),
    ("wfm_bench.py", 900),
    ("channelizer_bench.py", 900),
    ("dmr_bench.py", 900),
    ("mm_bench.py", 900),
    ("resampler_bench.py", 900),
    ("ofdm_bench.py", 1200),
    ("trellis_bench.py", 900),
    ("stream_service_bench.py", 900),
    ("psk_bench.py", 1800),
    ("atsc_bench.py", 1800),
    ("vocoder_bench.py", 1200),
]


def run_one(name: str, timeout: int):
    """One benchmark in its own process.

    Returns (records, None) on success or (None, diagnostic) on failure;
    the diagnostic keeps rc, elapsed and the stderr tail."""
    diag = {"name": name}
    t0 = time.time()
    try:
        r = subprocess.run(
            [sys.executable, os.path.join(HERE, name)],
            capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    except subprocess.TimeoutExpired as e:
        tail = e.stderr or ""
        if isinstance(tail, bytes):
            tail = tail.decode("utf-8", "replace")
        diag.update(rc=None, elapsed_s=round(time.time() - t0, 1),
                    stderr_tail=tail[-2000:], error="timeout")
        return None, diag
    recs = [json.loads(line) for line in r.stdout.splitlines()
            if line.strip().startswith("{")]
    if r.returncode == 0 and recs and all("device" in x for x in recs):
        elapsed = round(time.time() - t0, 1)
        for rec in recs:
            rec["bench_elapsed_s"] = elapsed
        return recs, None
    diag.update(rc=r.returncode, elapsed_s=round(time.time() - t0, 1),
                stderr_tail="\n".join(r.stderr.splitlines()[-10:]),
                error=("nonzero rc" if r.returncode else
                       "no JSON output" if not recs else
                       "a record names no device"))
    return None, diag


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", help="bench files to run (default all)")
    ap.add_argument("-o", "--output",
                    default=os.path.join(ROOT, "out", "bench_chains.json"))
    args = ap.parse_args(argv)
    only = set(args.names)
    out = {"host_card": bench.card_info(), "chains": [], "failed": []}
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    for name, timeout in BENCHES:
        if only and name not in only:
            continue
        print(f"== {name}", flush=True)
        recs, diag = run_one(name, timeout)
        if recs is None:
            out["failed"].append(diag)
            print(f"   FAILED: {json.dumps(diag)}", flush=True)
        else:
            for rec in recs:
                rec["bench"] = name
                out["chains"].append(rec)
                print("  ", json.dumps(rec), flush=True)
        # rewritten after every bench, so a cut run keeps what it measured
        with open(args.output, "w") as f:
            json.dump(out, f, indent=1)
    failed = out["failed"]
    print(f"wrote {args.output}: {len(out['chains'])} records, "
          f"{len(failed)} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the Alg. 2 game of the S5P-based rows on one GPU, in turns with
another ``core/game.py``.

    python3 scripts/bench_game.py --baseline build/parent/src/repro_torch/core/game.py

Runs S5P, S5P-exact and CLUGP (``core.baselines.PARTITIONERS``, their
default configurations) on the Graph500 R-MAT at ``--scale`` 20 (a=0.57,
b=c=0.19, seed 0), k = 32, on the card, and keeps each run's game inputs
(``S5POutput.aux``).  Then, for each row, ``run_game`` of the baseline
module and of this checkout's ``core/game.py`` on the same inputs and
arguments (batch size and leaders as the run had them; ``S5PConfig``'s
default rounds, acceptance and seed), in turns: baseline, new, new,
baseline (new twice without a baseline).  Each game's seconds are the host
clock around it, ending in a synchronise.  Each line states the rounds,
the new game's report (hub batches, ordered sums, replayed rounds, the
largest guarded partition size and hub-batch W) and whether the baseline's
assignment equals the new one's bit for bit.

The baseline file is loaded as a module of this checkout's
``repro_torch.core`` package, so it must import only what that package has
(the parent's ``game.py`` does).  One JSON line per game; last, the card's
name and power limit.  Every line also goes, as it is printed, to
``--out`` (default ``bench_game.jsonl`` in ``chip_smoke.py``'s output
directory).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_OUT: list = []


def _emit(obj) -> None:
    """Print one line, and append it to the output file at once (a long run
    cut by a time limit keeps what it measured)."""
    line = json.dumps(obj)
    print(line, flush=True)
    with open(_OUT[0], "a") as f:
        f.write(line + "\n")


def _load_baseline(path: str):
    spec = importlib.util.spec_from_file_location("repro_torch.core._baseline_game", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--baseline", default=None, help="another core/game.py, timed in turns")
    ap.add_argument("--rows", default="s5p,s5p-exact,clugp")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    path = args.out or os.path.join(ROOT, "chiprun_out", "bench_game.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "w").close()
    _OUT.append(path)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_game: no CUDA device")
    from repro_torch.core import game as new
    from repro_torch.core.baselines import PARTITIONERS
    from repro_torch.core.s5p import S5PConfig
    from repro_torch.graphs import rmat_graph
    from repro_torch.kernels import _build

    _build.build_all()
    base = _load_baseline(args.baseline) if args.baseline else None
    src, dst, n = rmat_graph(args.scale, edge_factor=16, a=0.57, b=0.19, c=0.19, seed=0)
    cfg = S5PConfig(k=32)
    dev = torch.device("cuda")
    for row in args.rows.split(","):
        out = PARTITIONERS[row](src, dst, n, cfg.k, 0, device=dev, full_output=True)
        torch.cuda.synchronize()
        st, rep = out.aux["incremental"], out.aux["game"]
        C = out.n_clusters
        kw = dict(batch_size=rep["batch_size"], max_rounds=cfg.game_max_rounds,
                  accept_prob=cfg.game_accept_prob, seed=cfg.seed)
        _emit({"row": row, "clusters": C, "pairs": int(st["pair_a"].numel()),
               "pipeline_game_s": out.timings["game"], "pipeline_report": rep})

        def play(mod):
            inputs = mod.GameInputs(st["sizes"], st["pair_a"], st["pair_b"], st["pair_w"],
                                    rep["n_head"], cfg.k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = mod.run_game(inputs, C, **kw)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, res

        order = ["baseline", "new", "new", "baseline"] if base else ["new", "new"]
        results = {}
        for who in order:
            sec, res = play(base if who == "baseline" else new)
            line = {"row": row, "game": who, "seconds": sec, "rounds": res.rounds,
                    "converged": res.converged}
            if who == "new":
                line["report"] = {f: getattr(res, f) for f in res._fields
                                  if f not in ("assignment", "rounds", "converged")}
            results.setdefault(who, res.assignment)
            if "new" in results and who == "baseline" or "baseline" in results and who == "new":
                line["assignment_equal_to_other"] = bool(
                    torch.equal(results["new"], results["baseline"]))
            _emit(line)
        del out, st
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    _emit({"nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())

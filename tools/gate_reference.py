#!/usr/bin/env python3
"""Hold the port's trainer against the JAX package's on the CPU, on the
draws of chip_smoke.py's training accuracy gate.

Run from the root of a checkout, on the CPU (no card is used; it imports
both packages, as the CPU tests do, and is not part of the port):

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/gate_reference.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/gate_reference.py --seeds 0,1,2

For each seed, a CPU ``torch.Generator`` seeded with it draws, in the
order chip_smoke.py's phase 6 and ``tools/ab_kernels.py --gate`` draw them
on the card: the training set (patient 3, 16 + 16 chunks of 60 windows,
``stratify_chunks``), the port's fit (``pipeline.fit(gen, rec, cfg,
n_shards=2)``, default ``PipelineConfig``), and the held-out timeline (one
interictal hour, the 48-minute run-up, the seizure). Then:

- the JAX package fits on the same windows, as numpy
  (``repro.signal.pipeline.fit(PRNGKey(seed), ..., n_shards=2)``);
- the JAX package also fits on its own draw of the same sizes
  (``make_training_set(PRNGKey(seed), 3, ...)``, stratified), which checks
  that the port's EEG generator has the reference's distribution;
- every forest is scored on the same timeline through its own package's
  ``evaluate_timeline``, and the committed program
  (``src/repro_torch/assets/seizure_program``) through the port's
  ``evaluate_program``.

Each seed's line gives the window accuracies and the gaps; the last lines
give each one's mean and standard deviation over the seeds, and the
paired difference between the port-trained and the JAX-trained forest on
the same draw beside twice its standard error.
"""

from __future__ import annotations

import argparse
import math
import statistics
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.signal import eeg_data as jeeg
from repro.signal import pipeline as jpipeline
from repro_torch.serving import api
from repro_torch.signal import eeg_data, pipeline

ROOT = Path(__file__).resolve().parents[1]
PATIENT = 3
CHUNKS_PER_CLASS = 16
SHARDS = 2


def _accuracy(preds, labels: np.ndarray) -> float:
    return float((np.asarray(preds) == labels).mean())


def one_seed(seed: int, committed) -> dict[str, float]:
    per = eeg_data.WINDOWS_PER_MATRIX
    n = CHUNKS_PER_CLASS * per
    cfg, jcfg = pipeline.PipelineConfig(), jpipeline.PipelineConfig()

    gen = torch.Generator().manual_seed(seed)
    rec = eeg_data.stratify_chunks(eeg_data.make_training_set(gen, PATIENT, n, n))
    port = pipeline.fit(gen, rec, cfg, n_shards=SHARDS)
    timeline = eeg_data.make_test_timeline(gen, PATIENT, hours_interictal=1)
    labels = timeline.labels.numpy()
    jtimeline = jeeg.Recording(jnp.asarray(timeline.windows.numpy()), jnp.asarray(labels))

    key = jax.random.PRNGKey(seed)
    same = jpipeline.fit(key, jeeg.Recording(jnp.asarray(rec.windows.numpy()),
                                             jnp.asarray(rec.labels.numpy())),
                         jcfg, n_shards=SHARDS)
    own_rec = jeeg.stratify_chunks(jeeg.make_training_set(key, PATIENT, n, n))
    own = jpipeline.fit(key, own_rec, jcfg, n_shards=SHARDS)

    return {
        "port": _accuracy(pipeline.evaluate_timeline(port, timeline, cfg).window_preds, labels),
        "jax_same": _accuracy(jpipeline.evaluate_timeline(same, jtimeline, jcfg).window_preds,
                              labels),
        "jax_own": _accuracy(jpipeline.evaluate_timeline(own, jtimeline, jcfg).window_preds,
                             labels),
        "committed": _accuracy(pipeline.evaluate_program(committed, timeline).window_preds,
                               labels),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7,8,9")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    if jax.default_backend() != "cpu":
        print("gate_reference.py runs on the CPU: set JAX_PLATFORMS=cpu", file=sys.stderr)
        return 2
    committed = api.ScoringProgram.load(str(ROOT / "src/repro_torch/assets/seizure_program"),
                                        device="cpu")
    rows = []
    for seed in seeds:
        r = one_seed(seed, committed)
        r["gap_port"] = r["committed"] - r["port"]
        r["gap_jax_same"] = r["committed"] - r["jax_same"]
        r["gap_jax_own"] = r["committed"] - r["jax_own"]
        r["port_minus_jax_same"] = r["port"] - r["jax_same"]
        rows.append(r)
        print(f"seed {seed}: window accuracy: port-trained {r['port']:.4f}, JAX-trained on the "
              f"same windows {r['jax_same']:.4f}, JAX-trained on its own draw "
              f"{r['jax_own']:.4f}, committed program {r['committed']:.4f}; gaps to the "
              f"committed program: port {r['gap_port']:+.4f}, JAX same draw "
              f"{r['gap_jax_same']:+.4f}, JAX own draw {r['gap_jax_own']:+.4f}; port - JAX "
              f"(same draw) {r['port_minus_jax_same']:+.4f}", flush=True)
    for k in rows[0]:
        vals = [r[k] for r in rows]
        sd = statistics.stdev(vals) if len(vals) > 1 else 0.0
        print(f"over {len(rows)} seeds: {k} mean {statistics.mean(vals):+.4f}, sd {sd:.4f}, "
              f"min {min(vals):+.4f}, max {max(vals):+.4f}")
    diff = [r["port_minus_jax_same"] for r in rows]
    se = statistics.stdev(diff) / math.sqrt(len(diff)) if len(diff) > 1 else 0.0
    mean = statistics.mean(diff)
    verdict = "agree" if abs(mean) <= 2 * se else "disagree"
    print(f"port-trained - JAX-trained on the same draw: mean {mean:+.4f}, standard error "
          f"{se:.4f}, |mean| {'<=' if verdict == 'agree' else '>'} 2 SE = {2 * se:.4f}: the "
          f"two trainers {verdict}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

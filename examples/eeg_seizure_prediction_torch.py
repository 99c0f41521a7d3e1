"""The paper's experiment patient by patient, in the PyTorch port: the twin
of ``examples/eeg_seizure_prediction.py``.

Synthetic Freiburg-like EEG -> MSPCA denoising -> WPD features ->
MapReduce rotation forest -> 8-minute chunk votes -> the 3-of-5 alarm
rule -> lead-time report (the paper's Tables 1-2 and Figs 3-10), at the
paper's full width (``repro_torch.configs.eeg_paper.CONFIG``: windows of
3 x 2048 samples, 2048 x 180 MSPCA matrices, 288 features, 10 trees of
depth 6). On the card the path runs the port's kernels: K2 (the DWT of
MSPCA and the WPD tree) and K3 (MSPCA's per-scale Gram) in every feature
pass, K4 (the grower's histograms) in the fit and K1 (the forest's votes)
in the predictions and the timeline's engine.

  PYTHONPATH=src python examples/eeg_seizure_prediction_torch.py --patient 3
  PYTHONPATH=src python examples/eeg_seizure_prediction_torch.py --patient 3 --device cpu

The EEG comes from the port's ``signal/eeg_data.py`` through
``torch.Generator``s on the device, seeded from ``--patient`` (one for
each of the reference's three keys: training set, fit, test timeline).
The generative model is the reference's, the draws are not
(``jax.random`` cannot be reproduced), so the numbers agree with the JAX
example's only in their statistics.

The MapReduce map runs on a world of one rank in this process
(``launch.mesh.local_world``, whose ``make_host_mesh`` is the twin of the
reference's ``jax.make_mesh((1,), ("data",))``): the features go through
``process_recording_mapreduce`` on a real one-device ``data`` axis, its
gather included, as on more ranks, and one rank needs no second process
(``spawn_world`` would start one, seconds on the card). ``MapReduce.
run_local(1)`` would emulate the axis and skip the collective.

``run`` returns the results as plain Python and numpy; ``main`` prints
the reference's lines and a final ``json`` line of the results.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.eeg_paper import CONFIG
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import local_world
from repro_torch.signal import eeg_data, pipeline


def _generator(device: torch.device, patient: int, stream: int) -> torch.Generator:
    """Stream 0 draws the training set, 1 the fit, 2 the test timeline."""
    return torch.Generator(device=device).manual_seed(3 * patient + stream)


def _recording(rec, device: torch.device) -> eeg_data.Recording:
    """A Recording (or a (windows, labels) pair of arrays) on ``device``."""
    return eeg_data.Recording(*(
        (t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))).to(device)
        for t in rec))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(patient: int = 3, hours_interictal: int = 1, train_windows: int = 120, *,
        device: str | torch.device = "cuda", cfg: pipeline.PipelineConfig = CONFIG,
        recording=None, timeline=None, fitted=None, log=print) -> dict:
    """The experiment for one patient, in the reference's order. Given
    ``recording`` / ``timeline`` ((windows, labels) of numpy or tensors)
    they replace the draws; given ``fitted`` (a ``FittedPipeline`` or
    ``convert.fitted_to_arrays``'s dict) the forest is carried in and not
    fitted. Returns plain Python and numpy: the map's features, the
    training predictions and accuracy, the timeline's window and chunk
    votes, alarms, lead time and onset, the fitted pipeline's arrays and
    the seconds of each stage."""
    dev = resolve_device(device)
    seconds = {}

    # --- training set (paper Sec 2.6: interictal + preictal records) ------
    if recording is None:
        rec = eeg_data.make_training_set(
            _generator(dev, patient, 0), patient,
            n_interictal_windows=train_windows, n_preictal_windows=train_windows)
    else:
        rec = _recording(recording, dev)
    log(f"[eeg] patient {patient}: {rec.windows.shape[0]} train "
        f"windows of {rec.windows.shape[2]} samples x "
        f"{rec.windows.shape[1]} channels")

    # --- signal processing as a MapReduce job (the paper's map phase) -----
    t0 = time.perf_counter()
    with local_world("nccl" if dev.type == "cuda" else "gloo", dev.type) as mesh:
        feats = pipeline.process_recording_mapreduce(mesh, rec, cfg)
        _sync(dev)
    seconds["map"] = time.perf_counter() - t0
    log(f"[eeg] MapReduce signal processing: {tuple(feats.shape)} features "
        f"in {seconds['map']:.1f}s")

    # --- train rotation forest, report training accuracy (Table 1) --------
    t0 = time.perf_counter()
    if fitted is None:
        fitted = pipeline.fit(_generator(dev, patient, 1), rec, cfg)
    elif not isinstance(fitted, pipeline.FittedPipeline):
        fitted = convert.fitted_from_arrays(fitted, dev)
    _sync(dev)
    seconds["fit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    preds = pipeline.predict_windows(fitted, rec.windows, cfg)
    acc = float((preds == rec.labels).to(torch.float32).mean())
    seconds["predict"] = time.perf_counter() - t0
    log(f"[eeg] training accuracy: {acc * 100:.2f}% (paper: 89.85-99.87%)")

    # --- real-time test timeline (Figs 3-10) -------------------------------
    if timeline is None:
        test = eeg_data.make_test_timeline(
            _generator(dev, patient, 2), patient, hours_interictal=hours_interictal)
    else:
        test = _recording(timeline, dev)
    t0 = time.perf_counter()
    result = pipeline.evaluate_timeline(fitted, test, cfg)
    seconds["timeline"] = time.perf_counter() - t0
    chunks = result.chunk_preds.tolist()
    alarms = result.alarms.tolist()
    log("[eeg] chunk predictions (8 min each): " + "".join(str(c) for c in chunks))
    log("[eeg] alarm state              : " + "".join(str(a) for a in alarms))
    lead = float(result.lead_time_minutes)
    if lead >= 0:
        log(f"[eeg] ALARM {lead:.0f} minutes before seizure onset (paper: 30-70 min)")
    else:
        log("[eeg] no alarm raised (paper patient 14 case)")
    return {
        "patient": patient,
        "train_windows": int(rec.windows.shape[0]),
        "features": feats.cpu().numpy(),
        "train_preds": preds.cpu().numpy(),
        "train_accuracy": acc,
        "window_preds": result.window_preds.numpy(),
        "chunk_preds": chunks,
        "alarms": alarms,
        "lead_time_minutes": lead,
        "onset_chunk": int(result.onset_chunk),
        "fitted": convert.fitted_to_arrays(fitted),
        "seconds": seconds,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--patient", type=int, default=3)
    ap.add_argument("--hours-interictal", type=int, default=1)
    ap.add_argument("--train-windows", type=int, default=120)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    res = run(args.patient, args.hours_interictal, args.train_windows, device=args.device)
    keys = ("patient", "train_windows", "train_accuracy", "chunk_preds", "alarms",
            "lead_time_minutes", "onset_chunk", "seconds")
    print(json.dumps({k: res[k] for k in keys}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Write the full-width ScoringProgram that the PyTorch port serves.

Trains the JAX reference pipeline at its default ``PipelineConfig``
(10 trees of depth 6, 32 bins, F = 288 features) on one synthetic
patient and saves the frozen program through the JAX checkpoint store
into ``src/repro_torch/assets/seizure_program``. The port loads it with
``repro_torch.serving.ScoringProgram.load`` and needs no JAX to do so.

Seeds: the training recording is ``eeg_data.make_training_set(
PRNGKey(0), patient_id=3)`` (120 interictal + 120 preictal windows) and
the forest fit is ``pipeline.fit(PRNGKey(1), ...)``.

Run from the repository root (not collected by pytest: its name does not
start with ``test_``):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_port_program.py
"""

from __future__ import annotations

import os
import shutil

import jax

from repro.serving import api
from repro.signal import eeg_data, pipeline

PATIENT_ID = 3
DATA_SEED = 0
FIT_SEED = 1
OUT_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir,
    "src", "repro_torch", "assets", "seizure_program",
)


def main() -> None:
    cfg = pipeline.PipelineConfig()
    rec = eeg_data.make_training_set(jax.random.PRNGKey(DATA_SEED), PATIENT_ID)
    fitted = pipeline.fit(jax.random.PRNGKey(FIT_SEED), rec, cfg)
    program = api.ScoringProgram.from_fitted(fitted, cfg)
    out = os.path.normpath(OUT_DIR)
    if os.path.isdir(out):
        shutil.rmtree(out)
    print(program.save(out, step=0))


if __name__ == "__main__":
    main()

"""The port's real-data gate (``gansynth_tpu_torch/data/validate.py``,
``cli validate-data``) on the CPU, on TFRecords the port writes itself
(no TensorFlow).

- A clean fixture file passes every check, the superstep (two steps at
  stage 2 of a narrow config) and the roundtrip included; short or
  non-finite audio fails the schema check with a readable problem; a file
  the training filters would empty fails.
- Two faults of the reference are not copied: the superstep check trains
  on the waves and the pitches of one batch each step, and a file the
  reader cannot parse fails the schema check (``schema_ok: false`` with
  the error) instead of escaping the gate.
- The CLI maps the report to exit codes 0 and 1, refuses ``--ingest
  tfdata`` (exit 2) and needs a card unless asked for the CPU.
"""

import json

import numpy as np
import pytest
import torch

import gansynth_tpu_torch.data.validate as validate
from gansynth_tpu_torch import cli
from gansynth_tpu_torch.data.fixtures import (
    encode_example,
    tfrecord_frame,
    write_synthetic_tfrecords,
)
from gansynth_tpu_torch.data.native_tfrecord import make_native_iterator
from gansynth_tpu_torch.utils.config import Config
from torch_threads import two_torch_threads  # noqa: F401

NARROW = Config().with_overrides(
    {"model": {"latent_dim": 8, "fmap_base": 64, "fmap_max": 16,
               "fmap_min": 8}})
QUICK = dict(throughput_seconds=0.2, device="cpu")


@pytest.fixture(scope="module")
def notes(tmp_path_factory):
    path = tmp_path_factory.mktemp("validate") / "notes.tfrecord"
    return write_synthetic_tfrecords(str(path), num_examples=24,
                                     pitches=range(24, 85, 3), seed=0)


def _write_records(path, records):
    """NSynth-schema records of (audio, pitch, instrument_source)."""
    with open(path, "wb") as f:
        for audio, pitch, source in records:
            f.write(tfrecord_frame(encode_example(
                {"audio": np.asarray(audio, np.float32)},
                {"pitch": [pitch], "velocity": [100],
                 "instrument_family": [3], "instrument_source": [source],
                 "qualities": [0] * 10})))
    return str(path)


def test_clean_file_passes_every_check(notes, monkeypatch):
    """Every check passes, and step k of the superstep trains on batch
    k's waves with batch k's pitches (the reference pairs batch 2's waves
    with batch 3's pitches)."""
    import gansynth_tpu_torch.train.step as step_mod

    seen, make = [], step_mod.make_superstep

    def spy(config, stage):
        fn = make(config, stage)

        def superstep(state, waves, pitches, alphas):
            seen.append((waves.clone(), pitches.clone()))
            return fn(state, waves, pitches, alphas)

        return superstep

    monkeypatch.setattr(step_mod, "make_superstep", spy)
    report = validate.validate_data([notes], NARROW, max_examples=24,
                                    **QUICK)
    assert report["ok"] is True, report
    assert report["schema_ok"] and not report["schema_problems"]
    assert report["examples_scanned"] == 24
    assert report["trainable_acoustic_in_range"] == 24
    assert report["decode_ok"] and report["decode_ingest"] == "native"
    assert report["decode_headroom_vs_chip"] > 1
    assert sum(report["pitch_histogram"].values()) == 24
    assert set(report["source_histogram"]) == {"0"}
    assert report["train_check_ok"] and report["train_params_moved"]
    assert report["train_check_stage"] == 2
    assert np.isfinite(report["train_d_loss"])
    assert report["roundtrip_snr_db_median"] > 5.0
    json.dumps(report)

    (waves, pitches), = seen
    it = make_native_iterator([notes], NARROW, acoustic_only=True,
                              batch_size=8, shuffle=True, repeat=True, seed=0)
    batches = [next(it) for _ in range(3)]
    for k in range(2):
        np.testing.assert_array_equal(waves[k].numpy(), batches[k][0])
        np.testing.assert_array_equal(pitches[k].numpy(), batches[k][1])
    # the batches differ, so a pairing of one batch's waves with another
    # batch's pitches would show
    assert not np.array_equal(batches[1][1], batches[2][1])


def test_short_audio_fails_the_schema(tmp_path):
    bad = _write_records(tmp_path / "short.tfrecord",
                         [(np.zeros(100), 60, 0)])
    report = validate.validate_data([bad], NARROW, max_examples=4,
                                    run_train_check=False, **QUICK)
    assert report["ok"] is False and not report["schema_ok"]
    assert any("audio length" in p for p in report["schema_problems"])


def test_non_finite_audio_fails_the_schema(tmp_path):
    audio = np.zeros(64000, np.float32)
    audio[7] = np.nan
    bad = _write_records(tmp_path / "nan.tfrecord", [(audio, 60, 0)])
    report = validate.validate_data([bad], NARROW, max_examples=4,
                                    run_train_check=False, **QUICK)
    assert report["ok"] is False
    assert any("non-finite" in p for p in report["schema_problems"])


def test_zero_trainable_examples_fails(tmp_path):
    audio = np.zeros(64000, np.float32)
    bad = _write_records(tmp_path / "electronic.tfrecord",
                         [(audio, 60, 1), (audio, 70, 1)])
    report = validate.validate_data([bad], NARROW, max_examples=4, **QUICK)
    assert report["ok"] is False and report["schema_ok"]
    assert report["trainable_acoustic_in_range"] == 0
    assert "warning" in report and not report["train_check_ok"]
    assert "no trainable examples" in report["train_check_error"]


def test_a_reader_error_fails_the_schema_check(tmp_path, notes):
    """A corrupt record (its CRC no longer matches) makes the reader
    raise: the report says so; the gate does not crash."""
    data = bytearray(open(notes, "rb").read())
    data[100] ^= 0xFF
    bad = tmp_path / "corrupt.tfrecord"
    bad.write_bytes(bytes(data))
    report = validate.validate_data([str(bad)], NARROW, max_examples=4,
                                    run_train_check=False, **QUICK)
    assert report["ok"] is False
    assert report["schema_ok"] is False and not report["decode_ok"]
    assert "NativeTFRecordError" in report["schema_error"]
    assert any("schema scan" in p for p in report["schema_problems"])
    json.dumps(report)


def test_cli_exit_codes(notes, tmp_path, capsys):
    out = tmp_path / "report.json"
    argv = ["validate-data", "--data", notes, "--max-examples", "8",
            "--throughput-seconds", "0.2", "--skip-train-check"]
    assert cli.main([*argv, "--output", str(out)]) == 0
    assert json.loads(out.read_text())["ok"] is True
    assert "validate-data: OK" in capsys.readouterr().out
    bad = _write_records(tmp_path / "short.tfrecord",
                         [(np.zeros(100), 60, 0)])
    assert cli.main(["validate-data", "--data", bad,
                     "--throughput-seconds", "0.2",
                     "--skip-train-check"]) == 1
    assert cli.main(["validate-data", "--data",
                     str(tmp_path / "missing.tfrecord")]) == 2
    assert cli.main([*argv, "--ingest", "tfdata"]) == 2
    assert "TensorFlow" in capsys.readouterr().err


def test_cli_train_check_needs_a_card_unless_asked(notes):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["validate-data", "--data", notes, "--max-examples", "4",
                  "--throughput-seconds", "0.2"])


def test_demand_is_one_card_not_the_tpu():
    """The decode bar is the card's stage-6 rate (batch 8 at the measured
    118.533 ms a step), not the reference's TPU number (66.0)."""
    assert validate.DEMAND_EXAMPLES_PER_SEC == pytest.approx(67.4917,
                                                             abs=1e-4)

"""The narrow CPU copy of a ``train_wavegan`` cell: WaveGAN at width d = 2
over the full 65536 samples, in float32, batch 2, supersteps of 2 steps
and a cache of 16 notes; the weights are drawn from the seed as on the
card."""

MODEL = {"wavegan_dim": 2, "compute_dtype": "float32"}


def overrides(workload, config, tmp_path):
    return ({"model": MODEL, "train": {"batch_size": 2, "unroll": 2}},
            {"traffic": {"cached_notes": 16}})

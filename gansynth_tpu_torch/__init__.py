"""gansynth_tpu_torch — the PyTorch/CUDA port of ``gansynth_tpu``.

The JAX package ``gansynth_tpu`` stays the reference; this package mirrors
its module names so each counterpart is easy to find:

- ``utils``   — config dataclasses (a copy of the reference's), device
                selection and precision, EMA weight import and export,
                checkpoints, metrics logging, WAV files.
- ``ops``     — numpy constant builders and the synthesis direction of the
                spectral library (mel pseudo-inverse, phase accumulation,
                inverse STFT).
- ``kernels`` — hand-written CUDA kernels for Hopper (``sm_90a``) built
                with plain ``nvcc`` and bound with ``ctypes``, each beside
                its plain PyTorch version.
- ``models``  — the progressive pitch-conditioned generator and critic.
- ``synth``   — threefry (latents, permutations, randint), the keyed,
                seeded and latent samplers, and the portable serving
                artifact (``torch.export``).
- ``train``   — the WGAN-GP step and superstep, the schedule, the loop
                and the supervisor.
- ``data``    — synthetic notes, the TFRecord fixture writer and the
                native TFRecord reader (no TensorFlow).
- ``serve``   — the coalescing HTTP synthesis service.
- ``cli``     — ``train``, ``stop``, ``supervise``, ``export-ema``,
                ``export-model``, ``fixtures``, ``serve``, ``generate``,
                ``interpolate``, ``evaluate``, ``roundtrip`` and
                ``validate-data``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Nothing is imported eagerly here: importing the package starts no build,
thread or server.
"""

__version__ = "0.1.0"

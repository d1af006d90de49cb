"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
float32 (the synthesis float64), written from the published description
of GANSynth's "IF-Mel + H" model and its WGAN-GP step. It imports neither
JAX nor ``gansynth_tpu`` nor anything of ``gansynth_tpu_torch``, and takes
no weights, tables or noise that the program made: it reads the committed
``ema.npz`` itself, remakes the benchmark's critic weights and notes from
the seed, and draws the step's noise and batch indices from the run's
key with its own threefry.
"""

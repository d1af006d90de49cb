"""WGAN-GP training: losses, state and Adam, schedule, the train step."""

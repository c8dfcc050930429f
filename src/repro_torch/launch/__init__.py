"""Step factories for the LM stack (train, prefill and serve), its
continuous-batching server, its train driver, and the device mesh."""

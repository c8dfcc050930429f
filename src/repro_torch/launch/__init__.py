"""Step factories for the LM stack (prefill and serve), its continuous-
batching server, and the device mesh."""

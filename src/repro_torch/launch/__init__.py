"""Step factories for the LM stack (prefill and serve)."""

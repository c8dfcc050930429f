"""The deterministic synthetic LM data pipeline."""

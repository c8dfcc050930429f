"""Plan-time weight quantization."""

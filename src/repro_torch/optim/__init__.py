"""Optimizers (AdamW, Adafactor) and int8 quantization: the plan-time
weight quantizer and error-feedback gradient compression."""

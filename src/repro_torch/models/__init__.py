"""Network specs, parameter initialisation and shared layers."""

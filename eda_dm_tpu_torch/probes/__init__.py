"""Measurement probes of the port (run on one CUDA card)."""

"""Serving engines, steps and the host-side KV bookkeeping."""

"""Serving host stack of the port: paged KV cache, prefill planning,
requests, scheduler and the engine."""

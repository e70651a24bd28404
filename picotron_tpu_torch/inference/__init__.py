"""Serving: KV cache, sampling, engine and continuous batcher."""

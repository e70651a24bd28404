"""Model definitions (Llama)."""

"""Batched image generation and LLM decode serving."""

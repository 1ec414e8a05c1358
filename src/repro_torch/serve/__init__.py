"""Batched image generation."""

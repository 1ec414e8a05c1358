"""Executable GAN models and the LLM stack's transformer."""

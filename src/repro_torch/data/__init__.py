"""Data pipelines of the LLM training path."""

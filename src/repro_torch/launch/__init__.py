"""Command-line launchers of the LLM stack."""

"""Launchers: the LLM stack's command line (:mod:`.serve`) and the
device mesh with its launcher of ranks (:mod:`.mesh`)."""

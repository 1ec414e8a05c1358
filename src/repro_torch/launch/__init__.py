"""Launchers: the LLM stack's command line (:mod:`.serve`), the device
mesh with its launcher of ranks (:mod:`.mesh`), and the production
cells' plans (:mod:`.specs`) and dry-run (:mod:`.dryrun`)."""

"""The Table-I GAN topologies and the LLM stack's architecture configs
(data)."""

"""The Table-I GAN topologies (data)."""

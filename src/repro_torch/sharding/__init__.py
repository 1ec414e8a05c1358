"""Sharded execution on ``torch.distributed``: the collectives and
gradient rules of a sharded GAN program (:mod:`.collectives`), the ring
collective matmuls (:mod:`.collective_matmul`) and the rank-side parity
runner (:mod:`.parity`)."""

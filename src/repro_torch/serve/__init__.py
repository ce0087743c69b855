# Retrieval beyond one range-sharded index: ISN shards built from a random
# document split with the broker merge (``distributed_ir``), and anytime
# maximum-inner-product search over k-means ranges of dense candidates
# (``retrieval``). Submodules are imported by name.

"""One file a block type, found by the type's name (``weights.load_block``)."""

"""Data-parallel runs over several cards: :mod:`.distributed` (ranks,
sharding, collectives) and :mod:`.mesh` (the local group of ranks)."""

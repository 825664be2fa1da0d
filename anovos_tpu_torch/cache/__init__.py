"""Fingerprints, the write-ahead journal and the node store's commit and
lookup (the part of ``anovos_tpu/cache`` the streaming checkpoints and the
continuum need).  The runner's node cache, its capture hook and the
store's file objects, restore and eviction are not ported (ROADMAP.md
Queue A item 1), so a resumed run re-executes every node but the
streaming passes; the store's one writer is the continuum's snapshot
commit."""

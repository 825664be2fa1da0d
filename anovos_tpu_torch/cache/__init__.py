"""Fingerprints and the write-ahead journal (the part of
``anovos_tpu/cache`` the streaming checkpoints need).  The node-result
cache store and its capture hook are not ported (ROADMAP.md Queue A item
6), so a resumed run re-executes every node but the streaming passes."""

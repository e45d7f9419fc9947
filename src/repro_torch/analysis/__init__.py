"""Static checks of the port's launches before anything runs: the kernel
geometry lint (``kernelgeom.py``) and its ``Finding`` record
(``findings.py``). The reference's donation, recompile and sharding passes
are JAX-specific and have no counterpart here."""

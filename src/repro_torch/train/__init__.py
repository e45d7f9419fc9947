"""Fault-aware training: the optimizer, the FAT engines (one member at a
time, or a population at once under ``torch.func.vmap``) and the trainers
the eFAT orchestrator drives."""

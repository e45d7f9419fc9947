"""Fault-aware training: the optimizer, the train step and the
fault-tolerant loop with its checkpoints, the FAT engines (one member at a
time, or a population at once under ``torch.func.vmap``) and the trainers
the eFAT orchestrator drives."""
from repro_torch.train.fat_trainer import ClassifierFATTrainer, LMFATTrainer
from repro_torch.train.loop import LoopConfig, LoopState, run_training
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.population import PopulationFATEngine, SerialFATEngine, make_fat_engine
from repro_torch.train.step import make_eval_step, make_jit_train_step, make_loss_fn, make_train_step

__all__ = [
    "AdamWConfig",
    "ClassifierFATTrainer",
    "LMFATTrainer",
    "LoopConfig",
    "LoopState",
    "PopulationFATEngine",
    "SerialFATEngine",
    "adamw_init",
    "adamw_update",
    "make_eval_step",
    "make_fat_engine",
    "make_jit_train_step",
    "make_loss_fn",
    "make_train_step",
    "run_training",
]

"""Named dataset-mixture presets.

Capability parity target: reference `config/data_presets.py`
(SURVEY.md C4): `data_preset_single_cfg` / `data_preset_multi_cfg` —
named mixtures (maestro, slakh, guitarset, enstdrums dtp/dtm, mir_st500,
cmedia, rwc_pop, urmp, egmd, mir-1k, idmt-smt-bass, …) with per-split
weights. Presets reference index files under
``$YMT3_DATA_HOME/yourmt3_indexes`` (see data/indexes.py for the schema;
data/preprocess builds them).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

DATA_HOME_ENV = "YMT3_DATA_HOME"


def data_home() -> str:
    return os.environ.get(DATA_HOME_ENV, os.path.expanduser("~/ymt3_data"))


@dataclasses.dataclass(frozen=True)
class DatasetEntry:
    dataset: str
    weight: float = 1.0
    # eval-time vocabulary overrides (SURVEY.md C30 eval-vocab remapping)
    eval_program_vocab: Optional[str] = None
    eval_drum_vocab: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DataPreset:
    name: str
    entries: Tuple[DatasetEntry, ...]
    default_task: str = "mt3_full_plus"

    def index_files(self, split: str) -> list:
        from ..data.indexes import index_path
        return [index_path(data_home(), e.dataset, split) for e in self.entries]

    def weights(self) -> list:
        return [e.weight for e in self.entries]


PRESETS: Dict[str, DataPreset] = {}


def _reg(p: DataPreset) -> DataPreset:
    PRESETS[p.name] = p
    return p


_reg(DataPreset("maestro", (DatasetEntry("maestro", eval_program_vocab="piano_solo"),),
                default_task="piano_solo"))
_reg(DataPreset("slakh", (DatasetEntry("slakh", eval_program_vocab="gm_instr_class"),)))
_reg(DataPreset("guitarset", (DatasetEntry("guitarset", eval_program_vocab="guitar_solo"),)))
_reg(DataPreset("enstdrums_dtp", (DatasetEntry("enstdrums_dtp", eval_drum_vocab="ksh"),),
                default_task="drums_only"))
_reg(DataPreset("enstdrums_dtm", (DatasetEntry("enstdrums_dtm", eval_drum_vocab="ksh"),),
                default_task="drums_only"))
_reg(DataPreset("egmd", (DatasetEntry("egmd", eval_drum_vocab="gm_drum_8class"),),
                default_task="drums_only"))
_reg(DataPreset("mir_st500", (DatasetEntry("mir_st500", eval_program_vocab="singing_solo"),),
                default_task="singing_v1"))
_reg(DataPreset("cmedia", (DatasetEntry("cmedia", eval_program_vocab="singing_solo"),),
                default_task="singing_v1"))
_reg(DataPreset("urmp", (DatasetEntry("urmp", eval_program_vocab="urmp_instr"),)))
_reg(DataPreset("rwc_pop", (DatasetEntry("rwc_pop", eval_program_vocab="gm_instr_class"),)))
_reg(DataPreset("mir1k", (DatasetEntry("mir1k", eval_program_vocab="singing_solo"),),
                default_task="singing_v1"))
_reg(DataPreset("idmt_smt_bass", (DatasetEntry("idmt_smt_bass", eval_program_vocab="bass_solo"),)))

# The YourMT3+ "all" multi-dataset training mixture (weights follow the
# paper's emphasis on slakh/maestro; retune freely).
_reg(DataPreset("all_cross_final", (
    DatasetEntry("maestro", 2.0),
    DatasetEntry("slakh", 2.0),
    DatasetEntry("guitarset", 1.0),
    DatasetEntry("enstdrums_dtp", 1.0),
    DatasetEntry("egmd", 0.5),
    DatasetEntry("mir_st500", 1.0),
    DatasetEntry("cmedia", 0.5),
    DatasetEntry("urmp", 1.0),
    DatasetEntry("rwc_pop", 0.5),
    DatasetEntry("idmt_smt_bass", 0.5),
)))

# synthetic smoke preset (tests / CI): built by data/preprocess/synth.py
_reg(DataPreset("synth_smoke", (DatasetEntry("synth", 1.0),)))
# larger synthetic corpus for convergence/generalization runs
_reg(DataPreset("synth_big", (DatasetEntry("synthbig", 1.0),)))
# multi-instrument synthetic corpus (6 timbre-distinct pitched programs
# spanning 6 MC12 classes + drums) — the flagship/multi_f1 quality loop
_reg(DataPreset("synth_mc", (
    DatasetEntry("synthmc", 1.0, eval_program_vocab="gm_instr_class_mc12"),),
    default_task="mc13_full_plus_256"))
# v3 of the multi-instrument corpus (round 5): piano unison-detune beating
# + register anchors, frequency-dependent damping, damper-noise releases,
# per-class durations, hotter sustained classes, per-track 2–4-program
# subsets — the offset-observability + piano/guitar-confusability levers
# (VERDICT r4 items 4/5). Rendered by scripts/gen_synthmc.py v3.
_reg(DataPreset("synth_mc3", (
    DatasetEntry("synthmc3", 1.0, eval_program_vocab="gm_instr_class_mc12"),),
    default_task="mc13_full_plus_256"))
# drum-only synthetic corpus (full-kit groove+fill charts) — the ENST/e-GMD
# shaped DTM quality loop (BASELINE config 4); ksh eval vocab like the
# reference's enstdrums_dtp preset
_reg(DataPreset("synth_drum", (
    DatasetEntry("synthdrum", 1.0, eval_drum_vocab="ksh"),),
    default_task="drums_only"))


def get_data_preset(name: str) -> DataPreset:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown data preset {name!r}; known: {sorted(PRESETS)}")

"""The registered model zoo: network wrapper x forward process.

Counterpart of ctdd_tpu/models/zoo.py, for the entries built on the UNet
wrapper (`_unet_paul`), the residual MLP (`_residual_mlp`), the hollow
family (`_hollow`, `_hollow_logistics`, `_masked`, `_bert_enum`), the DDSM
score networks (`_sudoku`, `_protein`), the sequence transformer
(`_sequence_transformer`) and the binary transformer EBM (`_binary_ebm`).
Registered names match the JAX zoo so its configs resolve unchanged.
"""

from __future__ import annotations

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.models.base import DiffusionModel, compose


def _unet_paul(cfg):
    from ctdd_tpu_torch.networks.unet import UNetWrapper

    return UNetWrapper(cfg)


def _residual_mlp(cfg):
    from ctdd_tpu_torch.networks.mlp import ResidualMLP

    m = cfg.model
    return ResidualMLP(
        D=cfg.data.shape[0], S=cfg.data.S, num_layers=m.num_layers,
        d_model=m.d_model, hidden_dim=m.hidden_dim,
        time_scale_factor=m.time_scale_factor, temb_dim=m.temb_dim,
    )


def _hollow(cfg):
    from ctdd_tpu_torch.networks.hollow import HollowTransformerWrapper

    return HollowTransformerWrapper(cfg)


def _hollow_logistics(cfg):
    from ctdd_tpu_torch.networks.hollow import HollowLogisticsWrapper

    return HollowLogisticsWrapper(cfg)


def _masked(cfg):
    from ctdd_tpu_torch.networks.hollow import EnumerativeTransformerWrapper

    return EnumerativeTransformerWrapper(cfg)


def _bert_enum(cfg):
    from ctdd_tpu_torch.networks.hollow import BertEnumTransformerWrapper

    return BertEnumTransformerWrapper(cfg)


def _sequence_transformer(cfg):
    from ctdd_tpu_torch.networks.transformer import SequenceTransformer

    m = cfg.model
    return SequenceTransformer(
        S=cfg.data.S, num_layers=m.num_layers, d_model=m.d_model,
        num_heads=m.num_heads, dim_feedforward=m.dim_feedforward, dropout=m.dropout,
        num_output_FFresiduals=m.num_output_FFresiduals,
        time_scale_factor=m.time_scale_factor, temb_dim=m.temb_dim,
        use_one_hot_input=m.use_one_hot_input, use_cat=m.get("use_cat", True),
        max_len=cfg.data.shape[0],
        scale_input_embedding=m.get("scale_input_embedding", False),
        qk_norm=m.get("qk_norm", False), aux_key_classes=m.get("aux_key_classes", 0),
    )


def _binary_ebm(cfg):
    from ctdd_tpu_torch.networks.ebm import BinaryTransformerScoreFunc

    return BinaryTransformerScoreFunc(cfg)


def _sudoku(cfg):
    from ctdd_tpu_torch.networks.ddsm import SudokuScoreNetWrapper

    return SudokuScoreNetWrapper(cfg)


def _protein(cfg):
    from ctdd_tpu_torch.networks.ddsm import ProteinScoreNetWrapper

    return ProteinScoreNetWrapper(cfg)


_ZOO = {
    # name                                   (network, process)
    "UniformRateImageX0PredEMA":              (_unet_paul, "UniformRate"),
    "GaussianTargetRateImageX0PredEMAPaul":   (_unet_paul, "GaussianTargetRate"),
    "UniformRateUnetEMA":                     (_unet_paul, "UniformRate"),
    "UniVarUnetEMA":                          (_unet_paul, "UniformVariantRate"),
    "GaussianRateResidualMLP":                (_residual_mlp, "GaussianTargetRate"),
    "UniformRateResMLP":                      (_residual_mlp, "UniformRate"),
    "UniVarHollowEMA":                        (_hollow, "UniformVariantRate"),
    "UniVarHollowEMALogistics":               (_hollow_logistics, "UniformVariantRate"),
    "UniformMaskedEMA":                       (_masked, "UniformRate"),
    "UniVarMaskedEMA":                        (_masked, "UniformVariantRate"),
    "UniformHollowEMA":                       (_hollow, "UniformRate"),
    "GaussianHollowEMA":                      (_hollow, "GaussianTargetRate"),
    "UniVarBertEMA":                          (_bert_enum, "UniformVariantRate"),
    "UniformBertEMA":                         (_bert_enum, "UniformRate"),
    "UniformBDTEMA":                          (_hollow, "UniformRate"),
    "UniVarScoreNetEMA":                      (_sudoku, "UniformVariantRate"),
    "UniVarProteinScoreNetEMA":               (_protein, "UniformVariantRate"),
    "UniformRateSequenceTransformerEMA":      (_sequence_transformer, "UniformRate"),
    "BirthDeathRateSequenceTransformerEMA":   (_sequence_transformer, "BirthDeathForwardBase"),
    "UniVarBinaryEBMEMA":                     (_binary_ebm, "UniformVariantRate"),
}


def _make_entry(name, make_net, process_name):
    def build(cfg, device=None) -> DiffusionModel:
        # the process name is bound into the config, as the JAX zoo does
        if "rate_name" not in cfg.model:
            cfg.model.rate_name = process_name
        return compose(cfg, make_net(cfg), device=device)

    build.__name__ = name
    return build


for _name, (_net, _proc) in _ZOO.items():
    registry.models.register(_make_entry(_name, _net, _proc), name=_name)

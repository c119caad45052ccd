"""The registered model zoo: network wrapper x forward process.

Counterpart of ctdd_tpu/models/zoo.py, for the entries built on the UNet
wrapper (`_unet_paul`), the residual MLP (`_residual_mlp`), the hollow
family (`_hollow`, `_hollow_logistics`, `_masked`, `_bert_enum`), the DDSM
score networks (`_sudoku`, `_protein`), the sequence transformer
(`_sequence_transformer`), the binary transformer EBM (`_binary_ebm`), DiT
(`_dit`), U-ViT (`_uvit`) and the tauLDR U-Net (`_tau_unet`); the D3PM
models `UniBertD3PM` and `UniProteinD3PM` have no process. Registered
names match the JAX zoo so its configs resolve unchanged. The port's own
`AbsorbingSDARMoE`, SDAR's block-diffusion decoder (`_sdar_moe`) bound to
the absorbing process, has no JAX counterpart.
"""

from __future__ import annotations

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.models.base import DiffusionModel, compose
from ctdd_tpu_torch.utils.device import resolve_device


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


def _dit(cfg):
    from ctdd_tpu_torch.networks.dit import DiTWrapper

    return DiTWrapper(cfg)


def _uvit(cfg):
    from ctdd_tpu_torch.networks.uvit import UViTWrapper

    return UViTWrapper(cfg)


def _tau_unet(cfg):
    from ctdd_tpu_torch.networks.tau_unet import TauUNetWrapper

    return TauUNetWrapper(cfg)


def _sudoku(cfg):
    from ctdd_tpu_torch.networks.ddsm import SudokuScoreNetWrapper

    return SudokuScoreNetWrapper(cfg)


def _protein(cfg):
    from ctdd_tpu_torch.networks.ddsm import ProteinScoreNetWrapper

    return ProteinScoreNetWrapper(cfg)


def _sdar_moe(cfg):
    from ctdd_tpu_torch.networks.sdar_moe import SDARMoE

    return SDARMoE(cfg)


_ZOO = {
    # name                                   (network, process)
    "GaussianUViTEMA":                        (_uvit, "GaussianTargetRate"),
    "GaussianDiTEMA":                         (_dit, "GaussianTargetRate"),
    "GaussianTargetRateImageX0PredEMA":       (_tau_unet, "GaussianTargetRate"),
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
    "UniBertD3PM":                            (_bert_enum, None),
    "UniformBertEMA":                         (_bert_enum, "UniformRate"),
    "UniformBDTEMA":                          (_hollow, "UniformRate"),
    "UniVarScoreNetEMA":                      (_sudoku, "UniformVariantRate"),
    "UniVarProteinScoreNetEMA":               (_protein, "UniformVariantRate"),
    "UniProteinD3PM":                         (_protein, None),
    "UniformRateSequenceTransformerEMA":      (_sequence_transformer, "UniformRate"),
    "BirthDeathRateSequenceTransformerEMA":   (_sequence_transformer, "BirthDeathForwardBase"),
    "UniVarBinaryEBMEMA":                     (_binary_ebm, "UniformVariantRate"),
    "AbsorbingSDARMoE":                       (_sdar_moe, "Absorbing"),
}


# label-conditional networks: only DiT carries a LabelEmbedder (the other
# wrappers take no label, or take it and ignore it)
_LABEL_MODELS = frozenset({"GaussianDiTEMA"})


def _make_entry(name, make_net, process_name):
    def build(cfg, device=None) -> DiffusionModel:
        if process_name is None:  # the D3PM models carry no CTMC process
            return DiffusionModel(net=make_net(cfg).to(resolve_device(device)),
                                  process=None, cfg=cfg)
        # the process name is bound into the config, as the JAX zoo does
        if "rate_name" not in cfg.model:
            cfg.model.rate_name = process_name
        return compose(cfg, make_net(cfg), device=device,
                       has_label=name in _LABEL_MODELS)

    build.__name__ = name
    return build


for _name, (_net, _proc) in _ZOO.items():
    registry.models.register(_make_entry(_name, _net, _proc), name=_name)

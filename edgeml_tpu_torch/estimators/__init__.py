"""The reward estimators: ten regression families and two baselines."""

from .common import SaveOpt, StandardScaler, fit_model
from .linear import (
    LROpt, ENOpt, BROpt, SGDOpt, SVROpt, LSVROpt, KNROpt,
    fit_LR, fit_EN, fit_BR, fit_SGD, fit_SVR, fit_LSVR, fit_KNR,
)
from .trees import RFROpt, GBROpt, fit_RFR, fit_GBR
from .nn import EdgeDetectionNet
from .train_cnn import CNNOpt, fit_CNN
from .baselines import fit_af, fit_dcsb

MODEL_NAMES = ["LR", "EN", "BR", "SGD", "SVR", "LSVR", "RFR", "GBR", "KNR", "CNN"]
MODEL_FITTERS = [
    fit_LR, fit_EN, fit_BR, fit_SGD, fit_SVR, fit_LSVR, fit_RFR, fit_GBR,
    fit_KNR, fit_CNN,
]

__all__ = [
    "SaveOpt", "StandardScaler", "fit_model",
    "LROpt", "ENOpt", "BROpt", "SGDOpt", "SVROpt", "LSVROpt", "KNROpt",
    "RFROpt", "GBROpt", "CNNOpt",
    "fit_LR", "fit_EN", "fit_BR", "fit_SGD", "fit_SVR", "fit_LSVR",
    "fit_RFR", "fit_GBR", "fit_KNR", "fit_CNN", "fit_af", "fit_dcsb",
    "EdgeDetectionNet", "MODEL_NAMES", "MODEL_FITTERS",
]

"""Architecture registry of the port: the configurations it can run."""
from . import llama3_2_1b, paper_mlp

_MODULES = {
    "llama3.2-1b": llama3_2_1b,
    "paper-proxy": paper_mlp,
}


def get_config(name: str):
    return _MODULES[name].CONFIG


def get_smoke_config(name: str):
    return _MODULES[name].SMOKE

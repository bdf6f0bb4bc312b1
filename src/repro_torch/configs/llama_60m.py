"""Paper LLaMA 60m config (see llama_paper.py)."""
from repro_torch.configs.llama_paper import LLAMA_60M as CONFIG, smoke

SMOKE = smoke(CONFIG)

"""Paper LLaMA 130m config (see llama_paper.py)."""
from repro_torch.configs.llama_paper import LLAMA_130M as CONFIG, smoke

SMOKE = smoke(CONFIG)

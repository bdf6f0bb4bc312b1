"""Paper LLaMA 7b config (see llama_paper.py)."""
from repro_torch.configs.llama_paper import LLAMA_7B as CONFIG, smoke

SMOKE = smoke(CONFIG)

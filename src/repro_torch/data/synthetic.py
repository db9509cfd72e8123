# The class prompts of repro/data/synthetic.py (framework-free).

N_CLASSES = 8
CLASS_PROMPTS = [
    "a red disc", "a green disc", "a blue square", "a yellow square",
    "a red cross", "a cyan cross", "a green ring", "a magenta ring",
]

"""Chat prompt builders (reference application/common.h:191-195 /
common.cpp build_prompt_glm1/glm2 and the CLI console's plain concat).
``history`` is the alternating [user, assistant, user, ...] turn list; the
last element is the pending user query.
"""
from __future__ import annotations

from typing import List


def build_prompt_glm1(history: List[str]) -> str:
    """ChatGLM v1 rounds ("[Round i]\\n问：...\\n答：...", 0-based; a lone
    first query passes through verbatim)."""
    if len(history) == 1:
        return history[0]
    out = []
    for i in range(0, len(history), 2):
        out.append(f"[Round {i // 2}]\n问：{history[i]}\n答：")
        if i + 1 < len(history):
            out.append(history[i + 1] + "\n")
    return "".join(out)


def build_prompt_glm2(history: List[str]) -> str:
    """ChatGLM v2/3 rounds (1-based, double newlines)."""
    out = []
    for i in range(0, len(history), 2):
        out.append(f"[Round {i // 2 + 1}]\n\n问：{history[i]}\n\n答：")
        if i + 1 < len(history):
            out.append(history[i + 1] + "\n\n")
    return "".join(out)


def build_prompt(arch: str, history: List[str]) -> str:
    """The chat prompt of an architecture: ChatGLM's rounds (``"chatglm1"``
    is THUDM's v1, ``"chatglm"`` and ``"chatglm2/3/4"`` the later ones),
    else the turns joined by newlines."""
    if arch == "chatglm1":
        return build_prompt_glm1(history)
    if arch in ("chatglm", "chatglm2", "chatglm3", "chatglm4"):
        return build_prompt_glm2(history)
    out = []
    for i in range(0, len(history), 2):
        out.append(history[i] + "\n")
        if i + 1 < len(history):
            out.append(history[i + 1] + "\n")
    return "".join(out)

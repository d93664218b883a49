"""Chat template rendering.

Two-tier design (capability of reference src/tokenizer/tokenizer.cpp:74-346):

1. Raw Jinja template strings (from tokenizer metadata / HF
   tokenizer_config.json) render through a real Jinja engine with the
   HF context (messages, add_generation_prompt, bos/eos tokens) — exact
   for any model, including ones the family table doesn't know.
2. Family renderers reproduce the reference's string-templating engine
   byte-for-byte for every family it supports (chatml, llama2+variants,
   llama3, phi3, zephyr, monarch, gemma, orion, openchat, vicuna[-orca],
   deepseek, command-r, chatglm, minicpm, deepseek2, exaone3) — used for
   named families and as the fallback when Jinja isn't applicable.

Unknown templates fall back to chatml WITH a warning (the reference
logs an error and returns an empty prompt, tokenizer.cpp:337-340).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.logging import get_logger

log = get_logger("chat_template")

FAMILIES = (
    "chatml", "llama2", "mistral", "llama3", "phi3", "zephyr", "monarch",
    "gemma", "gemma2", "orion", "openchat", "vicuna", "vicuna-orca",
    "deepseek", "command-r", "chatglm3", "chatglm4", "minicpm", "deepseek2",
    "exaone3",
)


@dataclass
class ChatMessage:
    role: str  # "system" | "user" | "assistant"
    content: str


def _is_jinja(t: str) -> bool:
    return "{%" in t or "{{" in t


def detect_template(template: str) -> str:
    """Fingerprint a raw template string to a family (the reference's
    template_contains chain, tokenizer.cpp:83-340, same precedence)."""
    t = template or ""
    if t in FAMILIES:
        return t

    def has(s: str) -> bool:
        return s in t

    if has("<|im_start|>"):
        return "chatml"
    if has("[INST]"):
        return "llama2"
    if has("<|assistant|>") and has("<|end|>"):
        return "phi3"
    if has("<|user|>"):
        return "zephyr"
    if has("bos_token + message['role']"):
        return "monarch"
    if has("<start_of_turn>"):
        return "gemma"
    if has("'\\n\\nAssistant: ' + eos_token"):
        return "orion"
    if has("GPT4 Correct "):
        return "openchat"
    if has("USER: ") and has("ASSISTANT: "):
        return "vicuna-orca" if has("SYSTEM: ") else "vicuna"
    if has("### Instruction:") and has("<|EOT|>"):
        return "deepseek"
    if has("<|START_OF_TURN_TOKEN|>") and has("<|USER_TOKEN|>"):
        return "command-r"
    if has("<|start_header_id|>") and has("<|end_header_id|>"):
        return "llama3"
    if has("[gMASK]<sop>"):
        return "chatglm3"
    if has("<用户>"):
        return "minicpm"
    if has("'Assistant: ' + message['content'] + eos_token"):
        return "deepseek2"
    if has("[|system|]") and has("[|assistant|]") and has("[|endofturn|]"):
        return "exaone3"
    return ""


def render_jinja(template: str, messages: list[ChatMessage],
                 add_assistant_prompt: bool, bos_token: str = "",
                 eos_token: str = "") -> str | None:
    """Render a raw HF Jinja chat template; None if rendering fails."""
    try:
        import jinja2

        env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True)

        def raise_exception(msg):
            raise jinja2.TemplateError(msg)

        env.globals["raise_exception"] = raise_exception
        tpl = env.from_string(template)
        return tpl.render(
            messages=[{"role": m.role, "content": m.content}
                      for m in messages],
            add_generation_prompt=add_assistant_prompt,
            bos_token=bos_token, eos_token=eos_token,
        )
    except Exception as e:  # jinja missing or template uses unsupported ops
        log.debug(f"jinja render failed: {e}")
        return None


def _render_family(family: str, template: str, msgs: list[ChatMessage],
                   add_ass: bool) -> str:
    def has(s: str) -> bool:
        return s in template

    def trim(s: str) -> str:
        return s.strip()

    out: list[str] = []
    if family == "chatml":
        for m in msgs:
            out.append(f"<|im_start|>{m.role}\n{m.content}<|im_end|>")
        if add_ass:
            out.append("<|im_start|>assistant\n")
    elif family in ("llama2", "mistral"):
        # reference variant flags (tokenizer.cpp:92-128)
        support_system = has("<<SYS>>") or family == "mistral"
        space_around = has("' ' + eos_token")
        bos_inside = has("bos_token + '[INST]")
        strip_msg = has("content.strip()")
        inside_turn = True
        out.append("[INST] ")
        for m in msgs:
            content = trim(m.content) if strip_msg else m.content
            if not inside_turn:
                inside_turn = True
                out.append("<s>[INST] " if bos_inside else "[INST] ")
            if m.role == "system":
                if support_system:
                    out.append(f"<<SYS>>\n{content}\n<</SYS>>\n\n")
                else:
                    out.append(content + "\n")
            elif m.role == "user":
                out.append(f"{content} [/INST]")
            else:
                around = " " if space_around else ""
                out.append(f"{around}{content}{around}</s>")
                inside_turn = False
    elif family == "phi3":
        for m in msgs:
            out.append(f"<|{m.role}|>\n{m.content}<|end|>\n")
        if add_ass:
            out.append("<|assistant|>\n")
    elif family == "zephyr":
        for m in msgs:
            out.append(f"<|{m.role}|>\n{m.content}<|endoftext|>\n")
        if add_ass:
            out.append("<|assistant|>\n")
    elif family == "monarch":
        for i, m in enumerate(msgs):
            bos = "" if i == 0 else "<s>"
            out.append(f"{bos}{m.role}\n{m.content}</s>\n")
        if add_ass:
            out.append("<s>assistant\n")
    elif family in ("gemma", "gemma2"):
        system_prompt = ""
        for m in msgs:
            if m.role == "system":
                system_prompt = trim(m.content)
                continue
            role = "model" if m.role == "assistant" else m.role
            out.append(f"<start_of_turn>{role}\n")
            if system_prompt and role != "model":
                out.append(system_prompt + "\n\n")
                system_prompt = ""
            out.append(f"{trim(m.content)}<end_of_turn>\n")
        if add_ass:
            out.append("<start_of_turn>model\n")
    elif family == "orion":
        system_prompt = ""
        for m in msgs:
            if m.role == "system":
                system_prompt = m.content
            elif m.role == "user":
                out.append("Human: ")
                if system_prompt:
                    out.append(system_prompt + "\n\n")
                    system_prompt = ""
                out.append(f"{m.content}\n\nAssistant: </s>")
            else:
                out.append(f"{m.content}</s>")
    elif family == "openchat":
        for m in msgs:
            if m.role == "system":
                out.append(f"{m.content}<|end_of_turn|>")
            else:
                role = m.role[0].upper() + m.role[1:]
                out.append(f"GPT4 Correct {role}: {m.content}<|end_of_turn|>")
        if add_ass:
            out.append("GPT4 Correct Assistant:")
    elif family in ("vicuna", "vicuna-orca"):
        for m in msgs:
            if m.role == "system":
                if family == "vicuna-orca" or has("SYSTEM: "):
                    out.append(f"SYSTEM: {m.content}\n")
                else:
                    out.append(f"{m.content}\n\n")
            elif m.role == "user":
                out.append(f"USER: {m.content}\n")
            elif m.role == "assistant":
                out.append(f"ASSISTANT: {m.content}</s>\n")
        if add_ass:
            out.append("ASSISTANT:")
    elif family == "deepseek":
        for m in msgs:
            if m.role == "system":
                out.append(m.content)
            elif m.role == "user":
                out.append(f"### Instruction:\n{m.content}\n")
            else:
                out.append(f"### Response:\n{m.content}\n<|EOT|>\n")
        if add_ass:
            out.append("### Response:\n")
    elif family == "command-r":
        roles = {"system": "<|SYSTEM_TOKEN|>", "user": "<|USER_TOKEN|>",
                 "assistant": "<|CHATBOT_TOKEN|>"}
        for m in msgs:
            tok = roles.get(m.role)
            if tok:
                out.append(f"<|START_OF_TURN_TOKEN|>{tok}{trim(m.content)}"
                           f"<|END_OF_TURN_TOKEN|>")
        if add_ass:
            out.append("<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>")
    elif family == "llama3":
        for m in msgs:
            out.append(f"<|start_header_id|>{m.role}<|end_header_id|>\n\n"
                       f"{trim(m.content)}<|eot_id|>")
        if add_ass:
            out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    elif family in ("chatglm3", "chatglm4"):
        out.append("[gMASK]<sop>")
        for m in msgs:
            out.append(f"<|{m.role}|>\n{m.content}")
        if add_ass:
            out.append("<|assistant|>")
    elif family == "minicpm":
        for m in msgs:
            if m.role == "user":
                out.append(f"<用户>{trim(m.content)}<AI>")
            else:
                out.append(trim(m.content))
    elif family == "deepseek2":
        for m in msgs:
            if m.role == "system":
                out.append(m.content + "\n\n")
            elif m.role == "user":
                out.append(f"User: {m.content}\n\n")
            elif m.role == "assistant":
                out.append(f"Assistant: {m.content}<｜end▁of▁sentence｜>")
        if add_ass:
            out.append("Assistant:")
    elif family == "exaone3":
        for m in msgs:
            if m.role == "system":
                out.append(f"[|system|]{trim(m.content)}[|endofturn|]\n")
            elif m.role == "user":
                out.append(f"[|user|]{trim(m.content)}\n")
            elif m.role == "assistant":
                out.append(f"[|assistant|]{trim(m.content)}[|endofturn|]\n")
        if add_ass:
            out.append("[|assistant|]")
    else:
        raise ValueError(f"unknown template family '{family}'")
    return "".join(out)


def apply_chat_template(messages: list[ChatMessage] | list[dict],
                        template: str = "chatml",
                        add_assistant_prompt: bool = True,
                        bos_token: str = "", eos_token: str = "") -> str:
    """Render a conversation.

    template: a family name, or the raw template string from tokenizer
    metadata. Raw Jinja strings render through jinja2 first (exact);
    recognized families use the reference-parity renderers; anything
    else warns and falls back to chatml.
    """
    msgs = [ChatMessage(m["role"], m["content"]) if isinstance(m, dict) else m
            for m in messages]
    if template in FAMILIES:
        return _render_family(template, "", msgs, add_assistant_prompt)
    if _is_jinja(template):
        rendered = render_jinja(template, msgs, add_assistant_prompt,
                                bos_token, eos_token)
        if rendered is not None:
            return rendered
    family = detect_template(template)
    if not family:
        log.warning("unrecognized chat template; falling back to chatml "
                    "(reference would refuse: tokenizer.cpp:337-340)")
        family = "chatml"
    return _render_family(family, template, msgs, add_assistant_prompt)

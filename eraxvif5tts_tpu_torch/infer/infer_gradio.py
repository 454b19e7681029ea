"""Gradio web UI for inference on the port's wrapper (port of
`eraxvif5tts_tpu/infer/infer_gradio.py`; reference
`src/f5_tts/infer/infer_gradio.py`). Everything but :func:`build_app` is
gradio-free and runs without it; ``build_app`` imports gradio when called
and raises ImportError without it.

Tabs mirror the reference app:
- **Basic TTS** (`infer_gradio.py:189`): reference audio/text, NFE/CFG/speed/seed,
  cross-fade, silence removal.
- **Multi-Speech-Type** (`infer_gradio.py:295`): ``{speech_type}`` curly-tag routing
  — each named type carries its OWN reference audio + text
  (``parse_speechtypes_text``, reference `:270-290`).
- **Custom model loader** (`infer_gradio.py:71-89, 145-150`): load any
  checkpoint/vocab pair into a fresh wrapper at runtime, cached by path.

The voice-chat tab (reference `:541-722`) is implemented around a pluggable
``chat_fn: (messages) -> str`` — ``load_default_chat_fn()`` builds the
reference's Qwen2.5-3B-Instruct turn from weights already on the host (it
never downloads, and fails loudly without them), and any callable with the same signature (an API client, a local server, a test
fake) plugs straight into ``build_app(wrapper, chat_fn=...)``. The conversation
core (`ChatSession`) is pure and testable without gradio or an LLM.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from eraxvif5tts_tpu_torch.infer.utils import cross_fade_concat
from eraxvif5tts_tpu_torch.infer.utils_infer import infer_process, preprocess_ref_audio_text
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper


def parse_speechtypes_text(gen_text: str) -> list[dict[str, str]]:
    """Split ``{speech_type}`` tagged text into ordered segments
    (reference `infer_gradio.py:270-290`). Untagged leading text is 'Regular'."""
    tokens = re.split(r"\{(.*?)\}", gen_text)
    segments: list[dict[str, str]] = []
    current = "Regular"
    for i, token in enumerate(tokens):
        if i % 2 == 0:
            text = token.strip()
            if text:
                segments.append({"style": current, "text": text})
        else:
            current = token.strip()
    return segments


def generate_multistyle(
    wrapper: F5TTSWrapper,
    refs: dict[str, tuple[str, str]],  # style -> (ref_audio_path, ref_text)
    gen_text: str,
    nfe_step: int = 32,
    cfg_strength: float = 2.0,
    speed: float = 1.0,
    seed: Optional[int] = None,
    cross_fade_duration: float = 0.15,
) -> tuple[np.ndarray, int]:
    """Route each ``{style}`` segment to its own reference; unknown styles fall
    back to Regular (reference `infer_gradio.py:470-500` behavior)."""
    prepped: dict[str, tuple] = {}

    def get_ref(style: str):
        if style not in refs:
            style = "Regular"
        if style not in prepped:
            audio, text = refs[style]
            prepped[style] = preprocess_ref_audio_text(audio, text)
        return prepped[style]

    waves = []
    sr = wrapper.target_sample_rate
    for seg in parse_speechtypes_text(gen_text):
        ref_audio, ref_text = get_ref(seg["style"])
        wave, sr, _ = infer_process(
            ref_audio, ref_text, seg["text"], wrapper,
            nfe_step=nfe_step, cfg_strength=cfg_strength, speed=speed, seed=seed,
        )
        waves.append(np.asarray(wave))
    if not waves:
        return np.zeros(1, np.float32), sr
    return cross_fade_concat(waves, sr, cross_fade_duration), sr


@dataclass
class ModelSlot:
    """Runtime custom-model cache (reference `infer_gradio.py:84, 145-150`:
    reload only when the path changes)."""

    wrapper: F5TTSWrapper
    custom: Optional[F5TTSWrapper] = None
    custom_key: tuple = field(default_factory=tuple)

    def load_custom(self, ckpt_path: str, vocab_path: str = "",
                    model_name: str = "F5TTS_v1_Base") -> F5TTSWrapper:
        """A wrapper of the checkpoint on the default wrapper's device and
        dtype, rebuilt only when the key changes."""
        key = (ckpt_path, vocab_path, model_name)
        if self.custom is None or self.custom_key != key:
            self.custom = F5TTSWrapper(
                model_name=model_name, ckpt_path=ckpt_path,
                vocab_file=vocab_path or None, device=self.wrapper.device,
                compute_dtype=self.wrapper.compute_dtype,
            )
            self.custom_key = key
        return self.custom

    def active(self, use_custom: bool) -> F5TTSWrapper:
        if use_custom and self.custom is not None:
            return self.custom
        return self.wrapper


MAX_SPEECH_TYPES = 8

DEFAULT_SYSTEM_PROMPT = (
    "You are not an AI assistant, you are whoever the user says you are. You "
    "must stay in character. Keep your responses concise since they will be "
    "spoken out loud."
)  # reference infer_gradio.py:626


@dataclass
class ChatSession:
    """Voice-chat conversation state (reference `infer_gradio.py:623-652`).

    ``history`` is the (user, assistant) pair list the UI renders;
    ``messages`` is the role/content list handed to ``chat_fn``."""

    system_prompt: str = DEFAULT_SYSTEM_PROMPT
    history: list = field(default_factory=list)
    messages: list = field(default_factory=list)

    def __post_init__(self):
        if not self.messages:
            self.messages = [{"role": "system", "content": self.system_prompt}]

    def process_input(self, text: str, chat_fn) -> Optional[str]:
        """One chat turn (reference `:632-652`): append the user message, get
        the assistant reply from ``chat_fn(messages)``. Empty input is a no-op
        (returns None), matching the reference's early-outs."""
        text = (text or "").strip()
        if not text:
            return None
        self.messages.append({"role": "user", "content": text})
        self.history.append((text, None))
        response = str(chat_fn(self.messages)).strip()
        self.messages.append({"role": "assistant", "content": response})
        self.history[-1] = (text, response)
        return response

    def clear(self) -> None:
        """Reset conversation, keep the system prompt (reference `:679-686`)."""
        self.history = []
        self.messages = [{"role": "system", "content": self.system_prompt}]

    def set_system_prompt(self, prompt: str) -> None:
        """New system prompt resets the conversation (reference `:688-691`)."""
        self.system_prompt = prompt
        self.clear()


def load_default_chat_fn(model_name: str = "Qwen/Qwen2.5-3B-Instruct"):
    """The reference's chat backend (`infer_gradio.py:560-581`):
    Qwen2.5-3B-Instruct via transformers, from files already on the host
    (``local_files_only``: it never downloads). Raises ImportError / OSError
    with a clear message without transformers or the weights — pass your own
    ``chat_fn`` to ``build_app`` instead (any ``(messages) -> str`` callable)."""
    try:
        from transformers import AutoModelForCausalLM, AutoTokenizer
    except ImportError as e:
        raise ImportError("the default chat backend needs transformers; pass chat_fn= "
                          "(any (messages) -> str callable) to build_app instead") from e
    try:
        model = AutoModelForCausalLM.from_pretrained(model_name, torch_dtype="auto",
                                                     device_map="auto",
                                                     local_files_only=True)
        tokenizer = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
    except OSError as e:
        raise OSError(f"chat model {model_name!r} is not on this host (nothing is "
                      "downloaded); pass a local model directory, or chat_fn= to "
                      "build_app") from e

    def chat_fn(messages: list) -> str:
        prompt = tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        inputs = tokenizer(prompt, return_tensors="pt").to(model.device)
        out = model.generate(**inputs, max_new_tokens=512, temperature=0.7,
                             top_p=0.95, do_sample=True)
        return tokenizer.decode(out[0][inputs["input_ids"].shape[1]:],
                                skip_special_tokens=True).strip()

    return chat_fn


def synthesize_chat_response(wrapper: F5TTSWrapper, session: ChatSession,
                             ref_audio, ref_text: str,
                             remove_silence: bool = True):
    """TTS the last assistant reply in the reference voice
    (reference `generate_audio_response`, `infer_gradio.py:656-676`)."""
    if not session.history or ref_audio is None:
        return None
    _, last_response = session.history[-1]
    if not last_response:
        return None
    ref_audio, ref_text = preprocess_ref_audio_text(ref_audio, ref_text)
    wave, sr, _ = infer_process(ref_audio, ref_text, last_response, wrapper,
                                cross_fade_duration=0.15, speed=1.0)
    wave = np.asarray(wave)
    if remove_silence:
        from eraxvif5tts_tpu_torch.audio.silence import remove_silence_edges

        wave = remove_silence_edges(wave, sr)
    return sr, wave


def build_app(wrapper: F5TTSWrapper, chat_fn=None):
    try:
        import gradio as gr
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "gradio is not installed; use `eraxvif5tts-infer` (CLI) or the HTTP "
            "server (`eraxvif5tts-server`) instead"
        ) from e

    slot = ModelSlot(wrapper=wrapper)

    def tts(ref_audio, ref_text, gen_text, nfe_step, cfg_strength, speed, seed,
            cross_fade, remove_silence, use_custom):
        w = slot.active(bool(use_custom))
        ref_audio, ref_text = preprocess_ref_audio_text(ref_audio, ref_text)
        wave, sr, _ = infer_process(
            ref_audio, ref_text, gen_text, w,
            nfe_step=int(nfe_step), cfg_strength=float(cfg_strength),
            speed=float(speed), seed=int(seed) if seed else None,
            cross_fade_duration=float(cross_fade),
        )
        wave = np.asarray(wave)
        if remove_silence:
            from eraxvif5tts_tpu_torch.audio.silence import remove_silence_edges

            wave = remove_silence_edges(wave, sr)
        return sr, wave

    def multi_tts(gen_text, nfe_step, seed, use_custom, *type_fields):
        w = slot.active(bool(use_custom))
        refs: dict[str, tuple[str, str]] = {}
        for i in range(MAX_SPEECH_TYPES):
            name, audio, text = type_fields[3 * i: 3 * i + 3]
            if name and audio:
                refs[str(name).strip()] = (audio, str(text or ""))
        if "Regular" not in refs:
            raise gr.Error("the 'Regular' speech type needs reference audio")
        wave, sr = generate_multistyle(
            w, refs, gen_text, nfe_step=int(nfe_step),
            seed=int(seed) if seed else None,
        )
        return sr, wave

    def load_custom_fn(ckpt_path, vocab_path, model_name):
        if not ckpt_path:
            return "no checkpoint path given"
        try:
            slot.load_custom(ckpt_path, vocab_path, model_name)
            return f"loaded {ckpt_path} ({model_name})"
        except Exception as e:  # surface load errors in the UI
            return f"load failed: {e}"

    with gr.Blocks(title="EraXviF5TTS-TPU") as app:
        gr.Markdown("# EraXviF5TTS-TPU — zero-shot voice cloning")
        use_custom = gr.Checkbox(label="Use custom model (load in last tab)", value=False)
        with gr.Tab("Basic TTS"):
            ref_audio = gr.Audio(label="Reference audio", type="filepath")
            ref_text = gr.Textbox(label="Reference text (empty = auto transcribe)")
            gen_text = gr.Textbox(label="Text to generate", lines=4)
            with gr.Accordion("Advanced", open=False):
                nfe = gr.Slider(4, 64, value=32, step=2, label="NFE steps")
                cfg = gr.Slider(0.0, 4.0, value=2.0, step=0.1, label="CFG strength")
                speed = gr.Slider(0.3, 2.0, value=1.0, step=0.1, label="Speed")
                seed = gr.Number(value=0, label="Seed (0 = random)")
                cross_fade = gr.Slider(0.0, 1.0, value=0.15, step=0.01,
                                       label="Cross-fade (s)")
                remove_sil = gr.Checkbox(label="Remove silences", value=False)
            out = gr.Audio(label="Generated")
            gr.Button("Synthesize").click(
                tts, [ref_audio, ref_text, gen_text, nfe, cfg, speed, seed,
                      cross_fade, remove_sil, use_custom], out
            )
        with gr.Tab("Multi-Speech-Type"):
            gr.Markdown(
                "Mark segments with `{Type}` tags, e.g.\n"
                "```\n{Regular} Hello there. {Surprised} What?! {Whisper} bye...\n```\n"
                "Each type below carries its own reference audio + text."
            )
            type_fields = []
            for i in range(MAX_SPEECH_TYPES):
                with gr.Row():
                    name = gr.Textbox(label=f"Type {i+1} name",
                                      value="Regular" if i == 0 else "")
                    audio = gr.Audio(label="Reference audio", type="filepath")
                    text = gr.Textbox(label="Reference text")
                type_fields += [name, audio, text]
            gen_text2 = gr.Textbox(label="Text with {type} tags", lines=6)
            nfe2 = gr.Slider(4, 64, value=32, step=2, label="NFE steps")
            seed2 = gr.Number(value=0, label="Seed (0 = random)")
            out2 = gr.Audio(label="Generated")
            gr.Button("Synthesize").click(
                multi_tts, [gen_text2, nfe2, seed2, use_custom] + type_fields, out2
            )
        with gr.Tab("Voice Chat"):
            gr.Markdown(
                "Converse with an LLM that answers **in the reference voice**.\n"
                "Load the chat model (or pass `chat_fn=` to `build_app` for a "
                "custom backend), record or type a message, and the reply is "
                "synthesized with the reference audio's voice."
            )
            # per-browser-session conversation state (gr.State) — a module
            # -level ChatSession would interleave concurrent users' chats
            session_state = gr.State(None)
            chat_state = {"fn": chat_fn}  # the LLM is process-wide by design

            def _session(s):
                return s if isinstance(s, ChatSession) else ChatSession()

            def load_chat_model():
                if chat_state["fn"] is None:
                    try:
                        chat_state["fn"] = load_default_chat_fn()
                    except Exception as e:
                        return f"chat model unavailable: {e}"
                return "chat model ready"

            def chat_turn(s, audio_path, text, ref_audio_c, ref_text_c,
                          remove_sil):
                session = _session(s)
                if chat_state["fn"] is None:
                    raise gr.Error("load the chat model first (or launch with "
                                   "a custom chat_fn)")
                if audio_path and not (text or "").strip():
                    # transcribe the spoken message (reference :637-638)
                    _, text = preprocess_ref_audio_text(audio_path, text or "")
                if session.process_input(text, chat_state["fn"]) is None:
                    return session, session.history, None, ""
                audio = synthesize_chat_response(
                    slot.active(False), session, ref_audio_c, ref_text_c,
                    remove_silence=bool(remove_sil))
                return session, session.history, audio, ""

            def clear_chat(s):
                session = _session(s)
                session.clear()
                return session, [], None

            def set_prompt(s, p):
                session = _session(s)
                session.set_system_prompt(p)
                return session, []

            ref_audio_c = gr.Audio(label="Reference audio", type="filepath")
            ref_text_c = gr.Textbox(label="Reference text (empty = auto)")
            sys_prompt = gr.Textbox(label="System prompt",
                                    value=DEFAULT_SYSTEM_PROMPT, lines=2)
            remove_sil_c = gr.Checkbox(label="Remove silences", value=True)
            load_status = gr.Textbox(label="Chat model status", interactive=False)
            gr.Button("Load chat model").click(load_chat_model, [], load_status)
            chatbot = gr.Chatbot(label="Conversation")
            mic = gr.Audio(sources=["microphone"], type="filepath",
                           label="Speak your message")
            msg = gr.Textbox(label="Type your message", lines=1)
            audio_out_c = gr.Audio(label="Response", autoplay=True)
            msg.submit(chat_turn,
                       [session_state, mic, msg, ref_audio_c, ref_text_c,
                        remove_sil_c],
                       [session_state, chatbot, audio_out_c, msg])
            mic.stop_recording(chat_turn,
                               [session_state, mic, msg, ref_audio_c,
                                ref_text_c, remove_sil_c],
                               [session_state, chatbot, audio_out_c, msg])
            gr.Button("Clear conversation").click(
                clear_chat, [session_state],
                [session_state, chatbot, audio_out_c])
            sys_prompt.change(set_prompt, [session_state, sys_prompt],
                              [session_state, chatbot])
        with gr.Tab("Custom model"):
            ckpt_path = gr.Textbox(label="Checkpoint path (.pt/.safetensors)")
            vocab_path = gr.Textbox(label="Vocab file path (optional)")
            model_name = gr.Dropdown(
                ["F5TTS_v1_Base", "F5TTS_v1_Pruned_14", "F5TTS_v1_Pruned_12",
                 "F5TTS_Base", "F5TTS_Small", "E2TTS_Base"],
                value="F5TTS_v1_Base", label="Architecture preset")
            status = gr.Textbox(label="Status", interactive=False)
            gr.Button("Load").click(load_custom_fn,
                                    [ckpt_path, vocab_path, model_name], status)
    return app


def main(argv=None):
    import argparse

    from eraxvif5tts_tpu_torch.infer.utils_infer import compute_dtype_for, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--vocab", required=True)
    ap.add_argument("--vocoder-ckpt", default=None)
    ap.add_argument("--model", default="F5TTS_v1_Base")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device", default=None, help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    wrapper = F5TTSWrapper(model_name=args.model, ckpt_path=args.ckpt,
                           vocab_file=args.vocab, vocoder_ckpt_path=args.vocoder_ckpt,
                           device=dev, compute_dtype=compute_dtype_for(dev))
    build_app(wrapper).launch(server_port=args.port)


if __name__ == "__main__":
    main()

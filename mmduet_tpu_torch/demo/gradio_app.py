"""Gradio demo (reference `demo/app.py` UI contract).

Requires `gradio` (not baked into this image — use
`python -m mmduet_tpu_torch.demo.app` for the dependency-free demo). UI mirrors
the reference: threshold-mode radio (single-frame vs score-sum), score-head
checkboxes, remove-assistant-turns radio, threshold + frame-interval
sliders, live score plot, chat box injecting queries at the current video
time (`demo/app.py:84-177`)."""

from __future__ import annotations

import argparse
import threading
import time


def main(argv=None):
    try:
        import gradio as gr
    except ImportError as e:  # pragma: no cover
        raise SystemExit(
            "gradio is not installed; run the dependency-free demo instead:\n"
            "    python -m mmduet_tpu_torch.demo.app --video <file> ..."
        ) from e

    import numpy as np

    from ..data.video import decode_video
    from ..eval.inference import build_argparser, build_engine
    from .live import LiveInferForDemo

    p = argparse.ArgumentParser(parents=[build_argparser()], add_help=False,
                                conflict_handler="resolve")
    p.add_argument("--test_fname", default=None)
    p.add_argument("--input_dir", default=None)
    p.add_argument("--output_fname", default=None)
    p.add_argument("--port", type=int, default=7860)
    args = p.parse_args(argv)

    engine = build_engine(args)
    engine.__class__ = LiveInferForDemo
    # interactive serving: compile every hot shape up front so the first
    # frame/query/response of a live session never stalls on XLA
    engine.prewarm(vision=True)

    # reference demo's pause Event (`demo/app.py:13-14,185-197`): typing
    # pauses the stream so the query lands at the intended moment
    pause_event = threading.Event()
    pause_event.set()
    # ONE shared chat log (like the stdlib demo's self.chat): the
    # start_chat generator and user_message run as different gradio
    # events — a local history list in either would go stale and erase
    # the other's entries on the next yield
    chat_log: list = []
    # serializes engine mutations: on gradio 4.x events run on different
    # workers, and a submit landing mid-frame must not interleave
    # _feed/cursor/cache updates with the streaming loop
    engine_lock = threading.Lock()

    def start_chat(video_file, threshold_mode, score_heads, rm_turns,
                   threshold, frame_interval, history):
        engine.args.remove_assistant_turns = rm_turns == "remove"
        engine.args.stream_end_prob_threshold = (
            threshold if threshold_mode == "single frame" else None
        )
        engine.args.stream_end_score_sum_threshold = (
            threshold if threshold_mode == "score sum" else None
        )
        # a CLI launch in z-mode would otherwise shadow the UI-selected
        # policy (ThresholdPolicy checks threshold_z FIRST)
        engine.args.threshold_z = None
        engine.score_heads = list(score_heads)
        frames, fps, _ = decode_video(
            video_file, 1.0 / frame_interval, engine.cfg.frame_resolution,
            engine.args.max_num_frames,
        )
        # the WHOLE session setup holds the lock: a submit landing during
        # the multi-second reset/encode window must not interleave
        # _feed/cursor/cache mutations with it
        with engine_lock:
            engine.reset()
            engine.set_fps(frame_interval=frame_interval)
            engine.input_video_stream(frames)
            chat_log.clear()
        scores = []
        while True:
            # cooperative pause: keep yielding so a single-worker gradio
            # queue can still schedule the resume event (a bare .wait()
            # would wedge the worker forever on gradio 3.x)
            while not pause_event.wait(timeout=0.2):
                yield list(chat_log), _plot(scores)
            t0 = time.perf_counter()
            with engine_lock:
                res = engine.input_one_frame()
            if res is None:
                break
            scores.append((res["time"], res["informative_score"], res["relevance_score"]))
            if res["response"]:
                chat_log.append((None, f"[{res['time']:.1f}s] {res['response']}"))
            time.sleep(max(0.0, frame_interval - (time.perf_counter() - t0)))
            yield list(chat_log), _plot(scores)

    def _plot(scores):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 2.4))
        if scores:
            t, inf, rel = zip(*scores)
            ax.plot(t, inf, label="informative")
            ax.plot(t, rel, label="relevance")
        ax.set_ylim(0, 1)
        ax.legend(loc="upper right")
        return fig

    def user_message(msg, history):
        with engine_lock:
            engine.encode_given_query(msg)
            chat_log.append((f"[{engine.video_time:.1f}s] {msg}", None))
        pause_event.set()  # resume on submit, like the reference
        return "", list(chat_log)

    def pause_stream():
        pause_event.clear()

    with gr.Blocks(title="MMDuet-TPU") as demo_ui:
        gr.Markdown("## MMDuet-TPU — streaming video-text duet")
        with gr.Row():
            video = gr.Video(label="video")
            with gr.Column():
                threshold_mode = gr.Radio(
                    ["single frame", "score sum"], value="single frame",
                    label="threshold mode")
                score_heads = gr.CheckboxGroup(
                    ["informative_score", "relevance_score"],
                    value=["informative_score"], label="score heads")
                rm_turns = gr.Radio(["keep", "remove"], value="keep",
                                    label="assistant turns in context")
                threshold = gr.Slider(0.0, 3.0, value=0.3, label="threshold")
                frame_interval = gr.Slider(0.1, 2.0, value=0.5,
                                           label="frame interval (s)")
        plot = gr.Plot(label="per-frame scores")
        chat = gr.Chatbot(label="conversation")
        msg = gr.Textbox(label="ask about the video")
        start = gr.Button("start streaming")
        start.click(start_chat,
                    [video, threshold_mode, score_heads, rm_turns, threshold,
                     frame_interval, chat],
                    [chat, plot])
        msg.submit(user_message, [msg, chat], [msg, chat])
        msg.focus(pause_stream)
    demo_ui.queue().launch(server_port=args.port)


if __name__ == "__main__":
    main()

"""Concurrency and latency benchmark of the websocket server (port of the
JAX ``bin/ws_bench.py``): ``wav.scp`` requests from a pool of
``--num_concurrence`` client threads (that many in flight) through ``bin/ws_client.transcribe_file`` against
``bin/serve.py``; reports the total RTF and the mean, median, max and min
latency per request, writes the transcriptions as a trn and, with ``-t``,
scores them through ``bin/compute_wer --char -v``.

Usage (the server first, e.g. on the same host):
  python -m paper_accurate_fast_cheap_tpu_torch.bin.serve --model_dir d \\
      --port 10086 &
  python -m paper_accurate_fast_cheap_tpu_torch.bin.ws_bench -p 10086 \\
      -w wav.scp -s hyp.trn -n 8 [-t ref.trn]
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def get_args(argv=None):
    p = argparse.ArgumentParser(description="websocket concurrency bench")
    p.add_argument("-u", "--host", default="127.0.0.1")
    p.add_argument("-p", "--port", type=int, default=10086)
    p.add_argument("-w", "--wav_scp", required=True,
                   help="'key wav_path' per line")
    p.add_argument("-t", "--trans", default=None,
                   help="reference trn for CER scoring")
    p.add_argument("-s", "--save_to", required=True,
                   help="output transcription trn")
    p.add_argument("-n", "--num_concurrence", type=int, required=True)
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from paper_accurate_fast_cheap_tpu_torch.bin.ws_client import (
        transcribe_file)
    from paper_accurate_fast_cheap_tpu_torch.data.pipeline import (
        _decode_one)

    wav_scp = []
    total_duration = 0.0
    with open(args.wav_scp, encoding="utf8") as f:
        for line in f:
            arr = line.strip().split()
            if not arr:
                continue
            if len(arr) != 2:
                raise ValueError(f"bad wav.scp line: {line!r}")
            s = _decode_one({"key": arr[0], "wav": arr[1]})
            total_duration += len(s["wav"]) / s["sample_rate"]
            wav_scp.append((arr[0], arr[1]))
    print(f"utts={len(wav_scp)} total_duration={total_duration:.2f}s")

    def one(item):
        key, path = item
        t0 = time.perf_counter()
        text = transcribe_file(args.host, args.port, path)
        return key, text, time.perf_counter() - t0

    texts, request_times, failed = [], [], 0
    begin = time.perf_counter()
    with ThreadPoolExecutor(max_workers=args.num_concurrence) as pool:
        for key, text, dt in pool.map(one, wav_scp):
            if text is None:
                failed += 1
                continue
            texts.append(f"{key}\t{text}\n")
            request_times.append(dt)
    request_time = time.perf_counter() - begin

    rtf = request_time / max(total_duration, 1e-9)
    print("For all concurrence:")
    print(f"\tfailed         : {failed}")
    print(f"\ttotal_duration : {total_duration:.2f}")
    print(f"\trequest_time   : {request_time:.2f}")
    print(f"\tRTF            : {rtf:.5f}")
    if request_times:
        print("For one request:")
        print(f"\tmean     : {statistics.mean(request_times):.3f}")
        print(f"\tmedian   : {statistics.median(request_times):.3f}")
        print(f"\tmax_time : {max(request_times):.3f}")
        print(f"\tmin_time : {min(request_times):.3f}")
    with open(args.save_to, "w", encoding="utf8") as fsave:
        fsave.write("".join(texts))
    if args.trans:
        from paper_accurate_fast_cheap_tpu_torch.bin import compute_wer

        compute_wer.main([args.trans, args.save_to, "--char", "-v"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A multi-function serverless app on FaaSFS: word count, map/reduce style.

Run:  PYTHONPATH=src python examples/torch_wordcount_functions.py

Three cloud functions share state purely through the filesystem — the
paper's programming model: "stateful server-based applications run with
little or no modification".

  ingest(doc, text)   writer  — store a document under /mnt/tsfs/wc/docs
  count_doc(doc)      writer  — tokenize one doc, merge counts into the
                                shared index (conflicts with concurrent
                                mergers -> transparent retry)
  top_words(n)        reader  — inferred read-only after its first run:
                                snapshot reads, no commit validation

Every invocation is one atomic transaction: a crash mid-`count_doc`
publishes nothing, a conflict restarts the function, and the final
`top_words` always sees a consistent index.
"""
import json
import re
import threading

from repro_torch.core.backend import BackendService
from repro_torch.core.client import LocalServer
from repro_torch.core.posix import O_CREAT, O_RDWR, O_TRUNC
from repro_torch.core.runtime import FunctionRuntime, InvocationStats
from repro_torch.core.types import CachePolicy

DOCS = {
    "zen": "simple is better than complex complex is better than complicated",
    "posix": "everything is a file a file is a sequence of bytes",
    "faas": "a function is a transaction a transaction is a function",
    "cache": "warm containers keep the cache warm between function calls",
}


def main() -> None:
    backend = BackendService(block_size=4096, policy=CachePolicy.EAGER)
    # two warm "containers", each with its own cache-carrying runtime
    workers = [FunctionRuntime(LocalServer(backend)) for _ in range(2)]
    rt = workers[0]

    # ---- function 1: ingest raw documents -----------------------------
    @rt.function
    def ingest(fs, doc, text):
        fs.makedirs("/mnt/tsfs/wc/docs", exist_ok=True)
        fd = fs.open(f"/mnt/tsfs/wc/docs/{doc}", O_CREAT | O_TRUNC | O_RDWR)
        fs.write(fd, text.encode())
        fs.close(fd)

    for doc, text in DOCS.items():
        ingest(doc, text)
    print(f"ingested {len(DOCS)} docs ->", end=" ")

    @rt.function(read_only=True)
    def listing(fs):
        return fs.readdir("/mnt/tsfs/wc/docs")

    print(listing())

    # ---- function 2: count one doc, merge into the shared index -------
    def count_doc(fs, doc):
        fd = fs.open(f"/mnt/tsfs/wc/docs/{doc}")
        text = fs.pread(fd, fs.fstat(fd)["st_size"], 0).decode()
        counts = {}
        for w in re.findall(r"[a-z]+", text):
            counts[w] = counts.get(w, 0) + 1
        ifd = fs.open("/mnt/tsfs/wc/index.json", O_CREAT | O_RDWR)
        raw = fs.pread(ifd, fs.fstat(ifd)["st_size"], 0)
        index = json.loads(raw) if raw else {}
        for w, n in counts.items():
            index[w] = index.get(w, 0) + n
        data = json.dumps(index, sort_keys=True).encode()
        fs.ftruncate(ifd, 0)
        fs.pwrite(ifd, data, 0)
        fs.close(ifd)
        fs.close(fd)

    # all four docs counted CONCURRENTLY from two warm containers: the
    # read-modify-write of index.json conflicts; the runtime retries
    stats = [InvocationStats() for _ in DOCS]
    threads = [
        threading.Thread(
            target=workers[i % 2].invoke, args=(count_doc, doc),
            kwargs={"stats": stats[i]},
        )
        for i, doc in enumerate(DOCS)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    attempts = sum(s.attempts for s in stats)
    aborts = sum(s.aborts for s in stats)
    print(f"counted concurrently: {attempts} attempts, {aborts} conflicts "
          "retried transparently")

    # ---- function 3: read the index (inferred read-only) ---------------
    @rt.function
    def top_words(fs, n):
        fd = fs.open("/mnt/tsfs/wc/index.json")
        index = json.loads(fs.pread(fd, fs.fstat(fd)["st_size"], 0))
        return sorted(index.items(), key=lambda kv: (-kv[1], kv[0]))[:n]

    first = top_words(5)       # runs read-write, observes zero effects
    s = InvocationStats()
    second = top_words(5, stats=s)   # now on the inferred read-only fast path
    assert first == second
    print("top words:", ", ".join(f"{w}={n}" for w, n in second),
          f"(read_only inferred: {s.read_only})")

    # sanity: the index agrees with a direct recount
    expect = {}
    for text in DOCS.values():
        for w in re.findall(r"[a-z]+", text):
            expect[w] = expect.get(w, 0) + 1
    best = sorted(expect.items(), key=lambda kv: (-kv[1], kv[0]))[:5]
    assert second == best, (second, best)
    print("runtime stats:", rt.stats)


if __name__ == "__main__":
    main()

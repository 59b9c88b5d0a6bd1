"""Child-process halves of the native runtime's cross-process tests
(``test_torch_native.py``) and the dataset its shared-memory loaders
read. A spawned child imports this module, which imports only numpy and
``paddle_tpu_torch.native``, so it starts in about a second."""

import numpy as np

WAIT_S = 120      # a child's bounded waits: wide, for a loaded host


def store_child(port, q):
    from paddle_tpu_torch import native
    client = native.TCPStore(port=port, timeout=WAIT_S)
    client.set("from_child", b"child_data")
    q.put(client.get("from_parent", timeout=WAIT_S))
    client.close()


def ring_producer(name):
    from paddle_tpu_torch import native
    ring = native.ShmRing.open(name)
    for i in range(100):
        ring.push(f"msg-{i}".encode(), timeout=WAIT_S)
    ring.push(b"__END__", timeout=WAIT_S)
    ring._h = None        # an opener never unlinks; the parent owns it


class Squares:
    """37 samples: each row i holds (i, i * i) and a float feature, so a
    batch is a dict of an int64 and a float32 array."""

    def __len__(self):
        return 37

    def __getitem__(self, i):
        return {"x": np.asarray([i, i * i], dtype=np.int64),
                "f": np.float32(i) / 7}

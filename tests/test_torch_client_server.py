"""The serving layer of tpu_ann_torch (utils/rpc.py, utils/client_server.py)
on the CPU, against the JAX package's: servers on localhost, each an index
over a slice of the rows with global ids; the client's merged result must
equal a one-index search (contrib/client_server.py's validation). The
frames are the reference's, so a port client fans out over a reference
server and a port server at once.

Every server thread is shut down by a finalizer; every socket the test
opens gets a 30 s timeout (socket.setdefaulttimeout around the module), so
no call waits without a bound. Data: d 32, 2000 rows of integers in [0,
256) from a numpy seed, so every distance is exact in f32 in both
packages. Tolerances: distances bit for bit, ids equal up to ties
(`assert_topk_equal`); the distributed k-means over rpc within 1e-3 of
the local one (the same host loop, sums added in another order)."""

import pickle
import socket

import numpy as np
import pytest
import torch

from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.idmap import IndexIDMap as JIDMap
from tpu_ann.utils import client_server as JCS
from tpu_ann.utils import rpc as jrpc
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.models.idmap import IndexIDMap as TIDMap
from tpu_ann_torch.models.ivf import IndexIVFFlat as TIVF
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.utils import client_server as TCS
from tpu_ann_torch.utils import contrib as TC
from tpu_ann_torch.utils import rpc
from torch_parity import assert_topk_equal

D, K = 32, 10
L2, IP = TD.METRIC_L2, TD.METRIC_INNER_PRODUCT


@pytest.fixture(autouse=True, scope="module")
def _bounded_sockets():
    old = socket.getdefaulttimeout()
    socket.setdefaulttimeout(30.0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    socket.setdefaulttimeout(old)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    r = np.random.RandomState(1234)
    xb = r.randint(0, 256, (2000, D)).astype(np.float32)
    xq = r.randint(0, 256, (50, D)).astype(np.float32)
    return xb, xq


@pytest.fixture
def serve(request):
    """serve(handler, module=rpc) -> the running server; shut down when
    the test ends."""
    def start(handler, module=rpc):
        srv = module.Server(handler)
        srv.serve_in_background()
        request.addfinalizer(srv.shutdown)
        return srv
    return start


@pytest.fixture
def connect(request):
    def open_client(servers, module=TCS, **kw):
        client = module.ClientIndex([("127.0.0.1", s.port) for s in servers],
                                    **kw)
        request.addfinalizer(client.close)
        return client
    return open_client


def _shard(pkg, xb, lo, hi, metric):
    if pkg == "torch":
        idx = TIDMap(TFlat(D, metric, device="cpu"))
        handler = TCS.SearchServer
    else:
        idx = JIDMap(JFlat(D, metric))
        handler = JCS.SearchServer
    idx.add_with_ids(xb[lo:hi], np.arange(lo, hi, dtype=np.int64))
    return handler(idx)


@pytest.mark.parametrize("metric,nshard", [(L2, 2), (IP, 3)])
def test_client_matches_single_index(data, serve, connect, metric, nshard):
    xb, xq = data
    bounds = np.linspace(0, len(xb), nshard + 1).astype(int)
    servers = [serve(_shard("torch", xb, lo, hi, metric))
               for lo, hi in zip(bounds[:-1], bounds[1:])]
    client = connect(servers, similarity=metric == IP)
    assert client.ntotal == len(xb)
    one = TFlat(D, metric, device="cpu")
    one.add(xb)
    Dr, Ir = one.search(xq, K)
    Dc, Ic = client.search(xq, K)
    assert Dc.dtype == np.float32 and Ic.dtype == np.int64
    assert_topk_equal(Dr, Ir, Dc, Ic)
    j = JFlat(D, metric)
    j.add(xb)
    assert_topk_equal(*j.search(xq, K), Dc, Ic)


def test_client_over_reference_and_port_servers(data, serve, connect):
    """One reference server (the JAX package's SearchServer and rpc.Server)
    and one port server behind a port ClientIndex; and a reference
    ClientIndex over the same two: both equal the reference's one-index
    result."""
    xb, xq = data
    servers = [serve(_shard("jax", xb, 0, 1000, L2), jrpc),
               serve(_shard("torch", xb, 1000, 2000, L2))]
    j = JFlat(D)
    j.add(xb)
    Dr, Ir = j.search(xq, K)
    for module in (TCS, JCS):
        client = connect(servers, module)
        assert client.ntotal == 2000
        assert_topk_equal(Dr, Ir, *client.search(xq, K))


def test_remote_nprobe_and_exception(data, serve, connect):
    xb, xq = data
    ivf = TIVF(TFlat(D, device="cpu"), D, 16, device="cpu")
    ivf.cp.niter = 4
    ivf.train(xb)
    ivf.add(xb)
    client = connect([serve(TCS.SearchServer(ivf))])
    client.set_nprobe(16)          # every list: exact
    assert ivf.nprobe == 16
    one = TFlat(D, device="cpu")
    one.add(xb)
    assert_topk_equal(*one.search(xq, K), *client.search(xq, K))
    c = client.sub_indexes[0]
    with pytest.raises(rpc.ServerException, match="remote traceback"):
        c.call("search", "not-an-array", 3)
    with pytest.raises(rpc.ServerException, match="private"):
        c.call("_repack")
    with pytest.raises(AttributeError):
        TCS.SearchServer(TFlat(D, device="cpu")).set_nprobe(4)


def test_restricted_unpickler():
    """The allowlist of the reference: numpy and scalar builtins; torch and
    any other class are refused."""
    for obj in (rpc.Server, torch.zeros(3)):
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            rpc._loads(pickle.dumps(obj))
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = rpc._loads(pickle.dumps(("ok", {"a": arr, "b": 3.5})))
    np.testing.assert_array_equal(out[1]["a"], arr)
    assert rpc._SAFE_BUILTINS == jrpc._SAFE_BUILTINS
    assert rpc._HDR.format == jrpc._HDR.format


def test_distributed_kmeans_over_rpc(serve, request):
    """DatasetAssign servers (port) behind DatasetAssignDispatch, reached
    only through rpc: the same centroids as the local k-means."""
    rs = np.random.RandomState(11)
    xt = rs.randn(3000, 24).astype(np.float32)
    clients = []
    for p in np.array_split(xt, 3):
        srv = serve(TC.DatasetAssign(p, device="cpu"))
        c = rpc.Client("127.0.0.1", srv.port)
        request.addfinalizer(c.close)
        clients.append(c)
    disp = TC.DatasetAssignDispatch(clients)
    assert disp.count() == 3000 and disp.dim() == 24
    c_rpc = TC.kmeans_assign(12, disp, niter=5, seed=3)
    c_loc = TC.kmeans_assign(12, TC.DatasetAssign(xt, device="cpu"),
                             niter=5, seed=3)
    np.testing.assert_allclose(c_rpc, c_loc, atol=1e-3)

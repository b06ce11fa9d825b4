/**
 * Browser client for the vosk_tpu websocket server (server/ws.py), which
 * speaks the vosk-server protocol the reference CLI client uses
 * (python/vosk/transcriber/transcriber.py:51-72):
 *   -> {"config": {"sample_rate": N, ...}}
 *   -> binary PCM s16le chunks
 *   -> {"eof": 1}
 *   <- {"partial": ...} / {"text": ..., "result": [...]} JSON per chunk
 *
 * The reference webjs/ is a hello-world placeholder; decoding in-browser
 * is out of scope for an accelerator framework — the browser streams audio
 * to an accelerator-backed server instead.
 */
class VoskTpuClient {
  /** @param {string} url e.g. "ws://localhost:2700" */
  constructor(url, { sampleRate = 16000, maxAlternatives = 0,
                     phraseList = null, words = false } = {}) {
    this.url = url;
    this.config = { sample_rate: sampleRate };
    if (maxAlternatives) this.config.max_alternatives = maxAlternatives;
    if (phraseList) this.config.phrase_list = phraseList;
    if (words) this.config.words = true;
    this.onresult = null;   // ({text, result}) finals
    this.onpartial = null;  // ({partial})
  }

  connect() {
    return new Promise((resolve, reject) => {
      this.ws = new WebSocket(this.url);
      this.ws.binaryType = "arraybuffer";
      this.ws.onopen = () => {
        this.ws.send(JSON.stringify({ config: this.config }));
        resolve(this);
      };
      this.ws.onerror = reject;
      this.ws.onmessage = (ev) => {
        const msg = JSON.parse(ev.data);
        if (msg.partial !== undefined) {
          if (this.onpartial) this.onpartial(msg);
        } else if (this.onresult) {
          this.onresult(msg);
        }
      };
    });
  }

  /** @param {Int16Array|ArrayBuffer} pcm s16le samples at config rate */
  acceptWaveform(pcm) {
    this.ws.send(pcm instanceof Int16Array ? pcm.buffer : pcm);
  }

  /** Flush and close; resolves with the final result message. */
  finish() {
    return new Promise((resolve) => {
      const prev = this.onresult;
      this.onresult = (msg) => { if (prev) prev(msg); resolve(msg); };
      this.ws.send(JSON.stringify({ eof: 1 }));
    });
  }

  close() { this.ws && this.ws.close(); }
}

if (typeof module !== "undefined") module.exports = { VoskTpuClient };
